"""Model primitives of the port: ``repro.models.components`` (norms,
rotary and M-RoPE, sinusoidal positions, GQA attention with optional
QKV bias, sliding-window and cross attention, SwiGLU / GELU MLPs, the
mixture of experts, tied or untied embeddings with the optional scale
and logit soft-cap), with the parameter specs (shapes and the
reference's logical axes) of each part.

On a training mesh a block's functions take ``tp`` (``sharding.spmd.
TP``), its split over ``model``: attention heads and the FFN's hidden
dim column-parallel with row-parallel ``wo`` / ``wd`` (f32 partials
summed, rounded once), experts expert-parallel (the reference's
``_moe_compute`` at ``ep_size`` = model), the vocabulary split in the
embedding and the unembedding, and a decode cache (a local-attention
ring, whisper's cross cache) split along its sequence
(``sharded_decode_attention``, ``cross_attention_block``).  With
``tp.seq`` (sequence parallelism, ``sharding/spmd.py``) a block's input
and output are the rank's sequence shard: column-parallel entries
gather it (``fanout_linear``), row-parallel exits reduce-scatter
(``row_parallel``, ``model_sum``), and work that does not split runs on
the whole sequence (``whole_sequence``).  ``tp=None`` is the
single-device path, unchanged.

Plain functions of ``(params, inputs, cfg)`` on tensors.  The dtype
contract is the reference's: activations in the compute dtype (bf16),
weights stored in ``cfg.param_dtype`` and cast to it at use, norms / RoPE / softmax / the
unembedding in f32, attention with bf16 operands and f32 accumulation.
Attention goes through the port's kernels (``kernels/flash_attention``,
``kernels/paged_attention``), and every projection ``x @ W`` through
``linear``: on the card the dataflow GEMM (``kernels/gemm_dataflow``,
output-stationary), whose fixed 128-tiles and ascending k give a row
the same bits whatever the number of rows in its call.

Where autograd needs a gradient (training: grad enabled and an input
that requires it) the two kernel calls go through their
``torch.autograd.Function``s: ``linear`` through ``LinearFn`` (the
backward's products on the same GEMM) and whole-sequence attention
through ``FlashAttentionFn`` (the hand-written backward kernel); the
unembedding builds its tiles without ``out=``.  Without a gradient
every path is the serving path, bit for bit.

Paged blocks write K/V into the page pool **in place** (the reference
returns updated pages functionally).  The fused step's write/read
disjointness (``repro.models.lm.fused_step_paged``) still holds: a
prefill row gathers its pages before any decode row of the same layer
writes, and the two groups' write targets are disjoint.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from ..kernels.flash_attention.ops import KV_TILE as FLASH_TILE
from ..kernels.flash_attention import flash_attention
from ..kernels.flash_attention.ops import (flash_attention_lse,
                                           flash_attention_train)
from ..kernels.gemm_dataflow.ops import LinearFn, project, project_f32
from ..kernels.paged_attention import paged_attention
from ..sharding.collectives import (all_gather, all_reduce, fanout, gather,
                                    reduce, reduce_scatter, scatter, split)
from ..sharding.spmd import MODEL, rank_heads, rank_kv_heads
from .base import ParamSpec, normal, ones, zeros

__all__ = ["linear", "remat", "fanout_linear", "replicated_linear",
           "head_columns_linear", "row_sum", "rms_norm", "layer_norm",
           "norm_specs",
           "apply_norm", "group_norm_heads", "rope_freqs", "apply_rope", "apply_mrope",
           "sinusoid_pos", "sinusoid_pos_at", "attn_specs", "project_qkv",
           "out_proj", "attention_block", "cross_attention_block",
           "encode_cross_kv", "mlp_specs", "mlp_block", "moe_specs",
           "moe_capacity", "moe_route", "moe_block",
           "embed_specs", "embed_tokens", "unembed", "unembed_local",
           "rank_slice", "expand_kv", "row_parallel", "model_sum",
           "model_rows", "whole_sequence", "gather_sequence", "fanout_tree",
           "sharded_decode_attention",
           "decode_attention", "decode_pos",
           "flash_decode_layout", "flash_decode_attention",
           "chunk_scatter_targets", "verify_scatter_targets",
           "paged_verify_attention_block",
           "paged_chunk_attention_block"]


# ---------------------------------------------------------- projection
def linear(x, w, bias=None, f32_out: bool = False, last: bool = False):
    """``x @ w`` (+ ``bias``) in x's dtype: the one product every
    projection of the port goes through.  x ``(..., K)``, w ``(K, N)``
    (cast to x's dtype), bias ``(N,)`` added in x's dtype after the
    product (the reference's order).

    On the card the rows go through the dataflow GEMM kernel
    (output-stationary: 128-deep k tiles, each formed from zero and
    added in ascending k, no atomics; an f32 product may spread its k
    tiles over blocks, which adds them in the same order), whose f32
    result is rounded once to x's dtype: a row has the same bits
    whether its call has 1 row or 4,096.  A library GEMM picks its
    kernel, and with it the summation order, by the shape, so the
    engine's 8-row decode and the oracle's 16-row decode would not give
    a row the same K/V.  On the CPU it is ``x @ w``.  Where a gradient
    is needed the product is ``LinearFn`` (on the card the same
    forward bits).  ``f32_out``: the product left in f32, unrounded (a
    row-parallel partial sum, rounded once after the sum over
    ``model``).  ``last``: a block's last product under ``remat``,
    whose output reaches the block's output through operations that
    save nothing (adds, casts, row cuts, collectives), so the backward
    never reads it: in the backward's recompute it saves x and w for
    its own dX and dW and launches nothing (``remat``)."""
    w = w.to(x.dtype)
    # the rows named, not -1: a rank with no heads has K = 0
    x2 = x.reshape(math.prod(x.shape[:-1]), x.shape[-1])
    if _needs_grad(x, w):
        y = LinearFn.apply(x2, w, f32_out,
                           last and getattr(_REMAT, "recompute", False))
    else:
        y = (project_f32 if f32_out else project)(x2, w)
    y = y.reshape(*x.shape[:-1], w.shape[1])
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


# ---------------------------------------------------------------- remat
#: set on the thread that runs a ``remat`` block's recompute
_REMAT = threading.local()


class _Recompute:
    """The recompute context of ``remat``'s checkpoint: while it is
    entered, a ``linear`` marked ``last`` skips its kernel."""

    def __enter__(self):
        _REMAT.recompute = True

    def __exit__(self, *_):
        _REMAT.recompute = False


def remat(fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant,
    early stop on): the forward keeps the block's inputs, and the
    backward recomputes the block until the last tensor the forward
    saved is saved again, where checkpoint stops it.  A block's last
    product (``linear``'s ``last``: the dense FFN's down projection,
    whole or row-parallel, and the shared expert's) saves its operands
    after its kernel has run, so the recompute would form its output,
    which nothing reads; in the recompute it saves them and launches
    nothing, as the reference's XLA drops that product of its
    ``jax.checkpoint`` as dead code.  The collectives after it are not
    replayed where that save is the block's last (the dense FFN); the
    MoE's aux loss saves after it, so its sum over ``model`` runs on
    the placeholder, as it ran on the product before."""
    with set_checkpoint_early_stop(True):
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=lambda: (contextlib.nullcontext(),
                                              _Recompute()))


def fanout_linear(x, *ws, tp):
    """``linear(x, w)`` for each of ``ws`` (a tuple, one output a
    weight; biases are the caller's), where x is replicated over
    ``model`` and each product is split work (``w`` this rank's
    columns, or whole weights whose output this rank cuts): the
    forwards are ``linear``'s, and x's gradient is this rank's f32
    partials dY w^T added, summed over ``model`` by one all-reduce and
    rounded once.  ``fanout(x)`` before each ``linear`` would round
    every partial to x's dtype before the sum: a second rounding, which
    put RWKV6's decay bias ``w0`` (its most cancelling bf16 gradient)
    8.7e-2 relative L2 from the single device's on an H100, 4.2e-2
    without it (PERF.md).

    With ``tp.seq`` x (B, S / m, D) is this rank's sequence shard: it is
    all-gathered along the sequence first, so the products see the
    whole (B, S, D), and the f32 partials of x's gradient are
    reduce-scattered along the sequence instead (Megatron's sequence
    parallelism: the all-reduce's sum, each rank keeping its rows),
    then rounded once."""
    ws = tuple(w.to(x.dtype) for w in ws)
    if tp.seq:
        lead = (x.shape[0], x.shape[1] * tp.size)
        if _needs_grad(x, *ws):
            ys = _GatherLinearFn.apply(x, tp.mesh, *ws)
        else:
            x2 = all_gather(x, tp.mesh, MODEL, 1).reshape(-1, x.shape[-1])
            ys = tuple(project(x2, w) for w in ws)
        return tuple(y.reshape(*lead, w.shape[1]) for y, w in zip(ys, ws))
    x2 = x.reshape(-1, x.shape[-1])
    if _needs_grad(x, *ws):
        ys = _FanoutLinearFn.apply(x2, tp.mesh, *ws)
    else:
        ys = tuple(project(x2, w) for w in ws)
    return tuple(y.reshape(*x.shape[:-1], w.shape[1])
                 for y, w in zip(ys, ws))


def _add_bias(y, bias):
    """``y`` plus ``bias`` in y's dtype, as ``linear`` adds it."""
    return y if bias is None else y + bias.to(y.dtype)


class _FanoutLinearFn(torch.autograd.Function):
    """``x @ w`` for each w (``fanout_linear``): dW = x^T dY as
    ``LinearFn``'s, dX the products' f32 partials added in order, then
    one all-reduce over ``model`` and one rounding."""

    @staticmethod
    def forward(ctx, x, mesh, *ws):
        ctx.save_for_backward(x, *ws)
        ctx.mesh = mesh
        return tuple(project(x, w) for w in ws)

    @staticmethod
    def backward(ctx, *dys):
        x, *ws = ctx.saved_tensors
        dys = [dy.to(x.dtype).contiguous() for dy in dys]
        dx = None
        if ctx.needs_input_grad[0]:
            for dy, w in zip(dys, ws):
                part = project_f32(dy, w.t().contiguous())
                dx = part if dx is None else dx + part
            dx = all_reduce(dx, ctx.mesh, MODEL).to(x.dtype)
        xt = x.t().contiguous() if any(ctx.needs_input_grad[2:]) else None
        dws = [project(xt, dy) if need else None
               for dy, need in zip(dys, ctx.needs_input_grad[2:])]
        return (dx, None, *dws)


class _GatherLinearFn(torch.autograd.Function):
    """``fanout_linear`` of a sequence shard x (B, S / m, D): x
    all-gathered along the sequence over ``model``, then ``x @ w`` for
    each w, the outputs flattened to rows; backward dW = x^T dY as
    ``LinearFn``'s, dX the products' f32 partials added in order, then
    one reduce-scatter along the sequence and one rounding."""

    @staticmethod
    def forward(ctx, x, mesh, *ws):
        xg = all_gather(x, mesh, MODEL, 1)
        ctx.shape, ctx.dtype, ctx.mesh = xg.shape, x.dtype, mesh
        x2 = xg.reshape(-1, xg.shape[-1])
        ctx.save_for_backward(x2, *ws)
        return tuple(project(x2, w) for w in ws)

    @staticmethod
    def backward(ctx, *dys):
        x, *ws = ctx.saved_tensors
        dys = [dy.to(x.dtype).contiguous() for dy in dys]
        dx = None
        if ctx.needs_input_grad[0]:
            for dy, w in zip(dys, ws):
                part = project_f32(dy, w.t().contiguous())
                dx = part if dx is None else dx + part
            dx = reduce_scatter(dx.reshape(ctx.shape), ctx.mesh, MODEL,
                                1).to(ctx.dtype)
        xt = x.t().contiguous() if any(ctx.needs_input_grad[2:]) else None
        dws = [project(xt, dy) if need else None
               for dy, need in zip(dys, ctx.needs_input_grad[2:])]
        return (dx, None, *dws)


def replicated_linear(x, w, tp):
    """``linear(x, w)`` of a weight that every rank of ``model`` holds
    whole, on an x and an output gradient that every rank holds alike
    (the replicated stream of the default rules, or a gradient
    all-gathered whole), so that every rank would compute the same
    dW = x^T dY: each computes only its 1 / m of dW's columns and one
    all-gather over ``model`` hands every rank the whole, as GSPMD
    partitions such a gradient.  The forward and dX are ``linear``'s; on
    the CPU a column of dW has the whole product's bits."""
    if (tp is None or tp.size == 1 or w.shape[1] % tp.size
            or not _needs_grad(w)):
        return linear(x, w)
    w = w.to(x.dtype)
    y = _ReplicatedLinearFn.apply(x.reshape(-1, x.shape[-1]), w, tp.mesh)
    return y.reshape(*x.shape[:-1], w.shape[1])


class _ReplicatedLinearFn(torch.autograd.Function):
    """``x @ w`` (``replicated_linear``): dX = dY w^T as ``LinearFn``'s,
    dW this rank's columns of x^T dY, all-gathered over ``model``."""

    @staticmethod
    def forward(ctx, x, w, mesh):
        ctx.save_for_backward(x, w)
        ctx.mesh = mesh
        return project(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        dx = project(dy, w.t().contiguous()) if ctx.needs_input_grad[0] \
            else None
        n = w.shape[1] // ctx.mesh.axis_size(MODEL)
        cols = dy.narrow(1, ctx.mesh.axis_index(MODEL) * n, n).contiguous()
        dw = all_gather(project(x.t().contiguous(), cols), ctx.mesh, MODEL,
                        1)
        return dx, dw, None


def head_columns_linear(x, w, bias, tp, head_dim: int):
    """``bias + linear(x, w)`` on this rank's heads' columns only, for a
    ``w`` (K, H head_dim) and an f32 ``bias`` (H head_dim,) or () (RWKV6's
    ``wd2`` and ``w0``: the reference's init draws one ``w0`` a layer,
    its spec one a channel) held whole by every rank of ``model``, an x
    alike on every rank, and an output that only this rank reads (its
    heads, ``tp.head_range``; the ranks' runs of heads uneven where
    ``model`` does not divide H).  The product and its dX cover the
    rank's columns: x's gradient is the ranks' f32 partials dY w_r^T
    summed by one all-reduce over ``model`` and rounded once
    (``fanout_linear``'s), and w's is this rank's columns of x^T dY,
    all-gathered over ``model`` (each rank's padded to the widest) with
    dY's column sums, the bias's gradient (their total for a ())."""
    widths = tuple(len(rank_heads(tp.n_heads, tp.size, r)) * head_dim
                   for r in range(tp.size))
    w = w.to(x.dtype)
    y = _HeadColumnsFn.apply(x.reshape(-1, x.shape[-1]), w, bias, tp.mesh,
                             widths)
    return y.reshape(*x.shape[:-1], y.shape[-1])


class _HeadColumnsFn(torch.autograd.Function):
    """``bias + x @ w`` on this rank's ``widths`` columns
    (``head_columns_linear``)."""

    @staticmethod
    def forward(ctx, x, w, bias, mesh, widths):
        i = mesh.axis_index(MODEL)
        start, n = sum(widths[:i]), widths[i]
        wr = w.narrow(1, start, n).contiguous()
        ctx.save_for_backward(x, wr)
        ctx.mesh, ctx.widths, ctx.whole = mesh, widths, bias.dim() == 0
        return (bias if ctx.whole else bias.narrow(0, start, n)) + project(
            x, wr)

    @staticmethod
    def backward(ctx, dy):
        x, wr = ctx.saved_tensors
        mesh, widths = ctx.mesh, ctx.widths
        dy = dy.to(x.dtype).contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = all_reduce(project_f32(dy, wr.t().contiguous()), mesh,
                            MODEL).to(x.dtype)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            part = torch.cat([project(x.t().contiguous(), dy),
                              dy.sum(0, keepdim=True)])
            n = max(widths)
            parts = all_gather(F.pad(part, (0, n - part.shape[1])), mesh,
                               MODEL, 1)
            if min(widths) < n:
                parts = torch.cat([parts.narrow(1, r * n, width)
                                   for r, width in enumerate(widths)], 1)
            dw, db = parts[:-1], parts[-1]
            if ctx.whole:
                db = db.sum()
        return dx, dw, db, None, None


def whole_sequence(fn, x, tp):
    """``fn(x, tp)`` of a block whose work does not split over
    ``model`` (a hidden dim or width that ``model`` does not divide;
    heads in a prefill that builds a cache): with ``tp.seq`` the
    sequence shard x is all-gathered, ``fn`` runs on the whole sequence
    exactly as without sequence parallelism (duplicated on every rank,
    its gradients whole on every rank), and each rank keeps its rows of
    its first output (``Split``: backward an all-gather, so the whole
    output's gradient reaches every rank's duplicated work, and x's
    gradient is this rank's rows of it).  ``fn`` returns a tensor, or a
    tuple whose first entry is the block's output."""
    if tp is None or not tp.seq:
        return fn(x, tp)
    out = fn(*gather_sequence(x, tp))
    if isinstance(out, tuple):
        return (model_rows(out[0], tp),) + out[1:]
    return model_rows(out, tp)


def gather_sequence(x, tp):
    """(the whole sequence of this rank's shard x, ``tp`` with ``seq``
    off): sequence parallelism's entry into work that runs on the whole
    sequence as without it, every rank of ``model`` the same, so x's
    gradient is this rank's rows of a gradient every rank holds whole
    (``Gather(split=False)``)."""
    return (gather(x, tp.mesh, MODEL, 1, split=False),
            dataclasses.replace(tp, seq=False))


def model_rows(y, tp):
    """This rank's sequence rows of y (B, S, ...), which every rank of
    ``model`` holds whole, under ``tp.seq`` (``Split``); else y."""
    if tp is None or not tp.seq:
        return y
    return split(y, tp.mesh, MODEL, 1)


def model_sum(y, tp):
    """The sum over ``model`` of f32 partials y (B, S, ...): all of it
    (``Reduce``), or under ``tp.seq`` this rank's sequence rows of it
    (``Scatter``, a reduce-scatter; backward an all-gather)."""
    if tp.seq:
        return scatter(y, tp.mesh, MODEL, 1)
    return reduce(y, tp.mesh, MODEL)


def fanout_tree(tree, tp):
    """Every leaf of a dict of replicated parameters, in f32, through
    ``fanout`` over ``model``: the leaves a rank consumes on its own
    sequence shard under ``tp.seq`` (the norms' scales and biases, a
    bias added after a row-parallel sum), whose gradient on each rank is
    its rows' share only.  A norm computes in f32, so its leaves' f32
    partials are summed before the one rounding to the leaf's dtype (a
    bf16 scale's partials rounded before the sum put it 3e-3 relative
    L2 from the default layout's on the CPU); a bias added in the
    compute dtype sums its rows' gradient in that dtype first, as the
    default layout does, then over ``model`` (whisper's ``b2``: 3.5e-3
    in bf16, 2e-7 in f32)."""
    if tp is None or not tp.seq:
        return tree
    if isinstance(tree, dict):
        return {k: fanout_tree(v, tp) for k, v in tree.items()}
    return fanout(tree.float(), tp.mesh, MODEL)


# ---------------------------------------------------------------- norms
def row_sum(x, dim: int = -1):
    """Sum over ``dim`` (kept, size 1) by halving: zero-pad to a power
    of two, then add the upper half onto the lower one until one value
    is left.  Every step is elementwise, so a row's sum is the same
    fixed tree of f32 additions whatever the other rows of the call: a
    library reduction picks its split of the work, and with it the
    order of the additions, by the number of rows (measured on the card:
    a LayerNorm row's bits at 2 or 8 rows differed from the same row in
    a 4,096-row call), which made a decode step's rows differ from the
    prefill's."""
    n = x.shape[dim]
    p = 1 << max(n - 1, 0).bit_length()
    if p != n:
        pad = [0, 0] * (x.dim() - 1 - dim % x.dim()) + [0, p - n]
        x = F.pad(x, pad)
    while p > 1:
        p //= 2
        x = x.narrow(dim, 0, p) + x.narrow(dim, p, p)
    return x


def row_mean(x, dim: int = -1):
    return row_sum(x, dim) / x.shape[dim]


def rms_norm(x, scale, eps: float):
    """RMSNorm scaled by ``1 + scale`` (zero-initialized scale), in f32."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


def layer_norm(x, scale, bias, eps: float):
    """LayerNorm scaled by ``scale`` (one-initialized), plus ``bias``
    when given, in f32.  Its mean and variance sum with ``row_sum``:
    ``torch.mean`` gave a row other bits at 2 or 8 rows than in a
    4,096-row call at widths 2,048 and 5,120 on the card, where it gave
    RMSNorm's mean of squares the same bits at every row count."""
    dt = x.dtype
    x = x.float()
    mu = row_mean(x)
    var = row_mean(torch.square(x - mu))
    y = (x - mu) * torch.rsqrt(var + eps)
    y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dt)


def norm_specs(d: int, kind: str) -> dict:
    if kind == "rmsnorm":
        return {"scale": ParamSpec((d,), ("stats",), init=zeros)}
    return {"scale": ParamSpec((d,), ("stats",), init=ones),
            "bias": ParamSpec((d,), ("stats",), init=zeros)}


def apply_norm(p, x, kind: str, eps: float):
    if kind == "rmsnorm":
        return rms_norm(x, p["scale"], eps)
    return layer_norm(x, p["scale"], p.get("bias"), eps)


def group_norm_heads(x, scale, bias, eps: float):
    """GroupNorm with one group per head; x (B, S, H, Dh), in f32."""
    dt = x.dtype
    x = x.float()
    mu = row_mean(x)
    var = row_mean(torch.square(x - mu))
    y = (x - mu) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(dt)


# ----------------------------------------------------------------- rope
def rope_freqs(rot_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                        device=device) / rot_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, *, theta: float = 1e4, fraction: float = 1.0):
    """x: (B, S, H, Dh); positions: (B, S) int.  ``fraction`` < 1
    rotates only the leading slice of Dh."""
    dh = x.shape[-1]
    rot = int(dh * fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    freqs = rope_freqs(rot, theta, x.device)
    ang = positions[..., None].float() * freqs              # (B, S, rot/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(xr.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


def apply_mrope(x, positions, *, theta: float, sections: tuple):
    """Multimodal RoPE (Qwen2-VL): positions (B, 3, S) carry the
    (temporal, height, width) ids; the Dh / 2 frequency slots are split
    into ``sections``, each rotated by its own position id."""
    dh = x.shape[-1]
    half = dh // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {sections} do not sum to {half}")
    freqs = rope_freqs(dh, theta, x.device)                  # (half,)
    # slot j's section, made on the device (no host copy: the lockstep
    # decode runs inside a CUDA graph's capture)
    slot = torch.arange(half, device=x.device)
    owner = ((slot >= sections[0]).long()
             + (slot >= sections[0] + sections[1]).long())   # (half,)
    pos = positions.float()                                  # (B, 3, S)
    ang = pos[:, owner].permute(0, 2, 1) * freqs             # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _sinusoid(pos, d: int):
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32,
                                 device=pos.device)
                    * (-math.log(10000.0) / d))
    ang = pos.float()[:, None] * div
    pe = torch.zeros((pos.shape[0], d), dtype=torch.float32,
                     device=pos.device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang)
    return pe


def sinusoid_pos(seq: int, d: int, device):
    """Sinusoidal embeddings of positions 0 .. seq - 1: (seq, d) f32."""
    return _sinusoid(torch.arange(seq, device=device), d)


def sinusoid_pos_at(pos, d: int):
    """Sinusoidal embedding at dynamic positions; pos (B,) -> (B, d)."""
    return _sinusoid(pos, d)


# ------------------------------------------------------------ attention
def attn_specs(cfg) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    h, kvh = cfg.n_heads, cfg.n_kv_heads
    p = {"wq": ParamSpec((d, h * hd), ("embed", "q_heads")),
         "wk": ParamSpec((d, kvh * hd), ("embed", "kv_heads")),
         "wv": ParamSpec((d, kvh * hd), ("embed", "kv_heads")),
         "wo": ParamSpec((h * hd, d), ("q_heads", "embed"))}
    if cfg.qkv_bias:
        p["bq"] = ParamSpec((h * hd,), ("stats",), init=zeros)
        p["bk"] = ParamSpec((kvh * hd,), ("stats",), init=zeros)
        p["bv"] = ParamSpec((kvh * hd,), ("stats",), init=zeros)
    if cfg.qk_norm:
        p["q_norm"] = ParamSpec((hd,), ("stats",), init=zeros)
        p["k_norm"] = ParamSpec((hd,), ("stats",), init=zeros)
    return p


def rank_slice(t, tp, n: int, dim: int = 0, start=None):
    """This rank's ``n`` entries along ``dim`` of a tensor replicated
    over ``model`` whose whole feeds work split over it (its gradient
    summed over ``model``): from ``start``, by default the rank's n-th
    (an uneven split of the heads gives its own)."""
    start = tp.index * n if start is None else start
    return fanout(t, tp.mesh, MODEL).narrow(dim, start, n)


def project_qkv(p, x, cfg, positions, mrope_positions=None, tp=None):
    """x: (B, S, D) -> q (B, S, H, Dh), k/v (B, S, KVH, Dh), QKV bias
    (added in the compute dtype after the product), qk-norm and RoPE or
    M-RoPE applied.  ``p`` is one layer's attention parameters.

    With ``tp.heads`` (heads split over ``model``): this rank's query
    heads (``tp.head_range``: H / m of them, or where m does not divide
    H ceil or floor of H / m, ``wq`` then cut by ``spmd.localize``), and
    its KVH / m KV heads (``tp.kv``) or, where m does not divide KVH,
    only the KV heads its query heads read (``spmd.rank_kv_heads``:
    their columns of the gathered ``wk`` / ``wv`` and of the biases
    taken before the product), normed and roped, then repeated to its
    query heads (``expand_kv``); the
    replicated biases and norm scales enter through ``fanout``, x
    through ``fanout_linear`` (with ``tp.seq`` x is this rank's sequence
    shard, which ``fanout_linear`` gathers: q, k, v hold the whole
    sequence)."""
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    bq, bk, bv = p.get("bq"), p.get("bk"), p.get("bv")
    qn, kn = p.get("q_norm"), p.get("k_norm")
    wk, wv = p["wk"], p["wv"]
    split = tp is not None and tp.heads
    if split:
        h = len(tp.head_range)
        qn, kn = (None if t is None else fanout(t, tp.mesh, MODEL)
                  for t in (qn, kn))
        bq = None if bq is None else rank_slice(
            bq, tp, h * hd, start=tp.head_range.start * hd)
        if tp.kv:
            kvh //= tp.size
            bk, bv = (None if t is None else rank_slice(t, tp, kvh * hd)
                      for t in (bk, bv))
        else:
            wk, wv, bk, bv = _rank_kv_columns(cfg, tp, wk, wv, bk, bv)
            kvh = wk.shape[1] // hd
    ws = (p["wq"], wk, wv)
    q, k, v = (fanout_linear(x, *ws, tp=tp) if split
               else tuple(linear(x, w) for w in ws))
    # unflatten, not reshape(B, -1, ...): a rank may hold no heads
    q = _add_bias(q, bq).unflatten(-1, (h, hd))
    k = _add_bias(k, bk).unflatten(-1, (kvh, hd))
    v = _add_bias(v, bv).unflatten(-1, (kvh, hd))
    if cfg.qk_norm:
        q = rms_norm(q, qn, cfg.norm_eps)
        k = rms_norm(k, kn, cfg.norm_eps)
    if cfg.rope_kind == "mrope":
        q = apply_mrope(q, mrope_positions, theta=cfg.rope_theta,
                        sections=cfg.mrope_sections)
        k = apply_mrope(k, mrope_positions, theta=cfg.rope_theta,
                        sections=cfg.mrope_sections)
    elif cfg.rope_kind == "rope":
        q = apply_rope(q, positions, theta=cfg.rope_theta,
                       fraction=cfg.rope_fraction)
        k = apply_rope(k, positions, theta=cfg.rope_theta,
                       fraction=cfg.rope_fraction)
    if split and not tp.kv:
        k, v = (expand_kv(t, cfg.n_heads, cfg.n_kv_heads, tp.size,
                          tp.index) for t in (k, v))
    return q.contiguous(), k.contiguous(), v.contiguous()


def _rank_kv_columns(cfg, tp, wk, wv, bk=None, bv=None):
    """This rank's columns of the whole (gathered) ``wk`` / ``wv`` and of
    the replicated ``bk`` / ``bv``: the KV heads its query heads read
    (``spmd.rank_kv_heads``).  Each slice's backward writes its gradient
    into zeros of the whole leaf; the weights' gather and the biases'
    ``fanout`` sum those over ``model``."""
    kv = rank_kv_heads(cfg.n_heads, cfg.n_kv_heads, tp.size, tp.index)
    first, n = kv.start * cfg.head_dim, len(kv) * cfg.head_dim
    return (wk.narrow(1, first, n), wv.narrow(1, first, n),
            *(None if b is None else
              fanout(b, tp.mesh, MODEL).narrow(0, first, n)
              for b in (bk, bv)))


def expand_kv(t, n_heads: int, n_kv_heads: int, size: int, index: int):
    """K or V (B, S, n, Dh) of the KV heads rank ``index`` of ``size``
    reads (``spmd.rank_kv_heads``) -> (B, S, h, Dh) of its h query heads
    (``spmd.rank_heads``): query head j takes KV head j // G, as every KV
    head repeated G-fold to the H query heads and cut to the rank's
    would.  A rank with no query heads reads no KV heads: (B, S, 0, Dh)."""
    g = n_heads // n_kv_heads
    q = rank_heads(n_heads, size, index)
    if not q:
        return t.narrow(2, 0, 0)
    first = rank_kv_heads(n_heads, n_kv_heads, size, index).start
    return t.repeat_interleave(g, dim=2).narrow(2, q.start - first * g,
                                                len(q))


def out_proj(p, out, tp=None):
    """(B, S, H, Dh) attention output -> (B, S, D).  With ``tp.heads``
    ``wo`` holds this rank's rows: the partial products are summed in
    f32 over ``model`` and rounded once."""
    x = out.flatten(2)
    if tp is None or not tp.heads:
        return linear(x, p["wo"])
    return row_parallel(x, p["wo"], tp)


def row_parallel(x, w, tp, last: bool = False):
    """``x @ w`` for a ``w`` holding this rank's rows of the whole
    product: the f32 partials summed over ``model``, rounded once to
    x's dtype (as ``linear`` rounds its one product); under ``tp.seq``
    reduce-scattered along the sequence (x (B, S, F) -> (B, S / m, D)).
    ``last``: as ``linear``'s (the sum is then not replayed)."""
    y = linear(x, w, f32_out=True, last=last)
    return model_sum(y, tp).to(x.dtype)


def attention_block(p, x, cfg, *, positions, causal: bool = True,
                    window=None, mrope_positions=None, cache=None,
                    cache_pos=None, paged: bool, tp=None):
    """The attention sub-layer on the contiguous path (the reference's
    ``attention_block``).  Returns (out (B, S, D), kv).

    Without ``cache`` (prefill): attention over the sequence through the
    flash kernel (causal or not, with the sliding ``window`` of local
    attention), and kv = this layer's {"k", "v"} in the compute dtype.
    With ``cache`` ({"k", "v"}: (B, S_max, KVH, Dh)), one decode step at
    position ``cache_pos``: the token's K/V is written into the cache in
    place and attention runs over it.  A windowed layer's cache is a
    ring of ``window`` slots (the prefill keeps its last ``window``
    keys): the token goes to slot ``cache_pos % window``.

    ``paged`` is the model's ``supports_paged_decode()``.  A decode
    step of a model the engine serves runs the paged kernel, as the
    engine's decode does, so this lockstep path is its bit-for-bit
    oracle; any other model's runs the flash kernel at one query row
    (``flash_decode_attention``), which gives the bits of the same row
    of a whole prefill: decode extends prefill exactly.

    ``tp`` (on a mesh): the split over ``model`` (``project_qkv``,
    ``out_proj``).  A decode cache holds every head: with ``tp.heads``
    the row's q, k, v heads are gathered (one packed all-gather), every
    head attends, and this rank's heads go to the row-parallel ``wo``.
    A cache split along its sequence (``tp.seq_shards``) goes through
    ``sharded_decode_attention``.

    With ``tp.seq`` (sequence parallelism) x is this rank's sequence
    shard and so is the output: split heads gather it in their QKV
    products (``fanout_linear``) and reduce-scatter ``wo``'s sum
    (``row_parallel``); whole heads run on the whole sequence
    (``whole_sequence``).  ``positions`` are the whole sequence's."""
    if tp is not None and tp.seq and not tp.heads:
        return whole_sequence(lambda x, tp: attention_block(
            p, x, cfg, positions=positions, causal=causal, window=window,
            mrope_positions=mrope_positions, paged=paged, tp=tp), x, tp)
    q, k, v = project_qkv(p, x, cfg, positions, mrope_positions, tp)
    if cache is None:
        if window is not None and q.shape[1] % window:
            # the reference's local_attention contract
            raise ValueError(f"local attention needs S % window == 0, got "
                             f"S = {q.shape[1]}, window = {window}")
        attend = (flash_attention_train if _needs_grad(q, k, v)
                  else flash_attention)
        out = attend(q, k, v, q_offset=0, causal=causal, window=window)
        return out_proj(p, out, tp), {"k": k, "v": v}
    kc, vc = cache["k"], cache["v"]
    split = tp is not None and tp.heads
    if split:
        q, k, v = _gather_heads(tp, q, k, v)
    if tp is not None and tp.seq_shards > 1:
        out = sharded_decode_attention(q, k, v, kc, vc, cache_pos, tp,
                                       window)
    else:
        out = _decode_whole(q, k, v, kc, vc, cache_pos, window, paged)
    if split:
        heads = tp.head_range
        out = out.narrow(2, heads.start, len(heads))
    return out_proj(p, out, tp), cache


def _gather_heads(tp, *ts):
    """Every head of one decode row's q, k, v from this rank's heads: one
    all-gather over ``model`` of the three packed along the head dim
    (a decode cache holds every head)."""
    sizes = [t.shape[2] for t in ts]
    got = all_gather(torch.cat(ts, 2), tp.mesh, MODEL, 2)
    parts = torch.split(got, sum(sizes), 2)          # one a rank
    return tuple(torch.cat([torch.split(r, sizes, 2)[i] for r in parts],
                           2).contiguous() for i in range(len(ts)))


def decode_pos(pos, device) -> torch.Tensor:
    """A decode cache's ``pos`` as the lockstep step reads it: a 0-d
    int32 tensor on ``device`` (the reference's traced scalar), made
    from a host int where a caller gives one; a tensor is not read."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.int32)
    return torch.full((), int(pos), dtype=torch.int32, device=device)


def _decode_whole(q, k, v, kc, vc, cache_pos, window, paged):
    """One decode step over a whole cache (see ``attention_block``),
    ``cache_pos`` a host int or a 0-d tensor: every index it gives is
    arithmetic on the device with fixed shapes (a CUDA graph replays
    the step at any position)."""
    pos = decode_pos(cache_pos, kc.device)
    ring = window is not None and kc.shape[1] == window
    slot = (pos % window if ring else pos).long().reshape(1)
    kc.index_copy_(1, slot, k.to(kc.dtype))
    vc.index_copy_(1, slot, v.to(vc.dtype))
    if paged and window is None:
        return decode_attention(q, kc, vc, pos + 1)
    return flash_decode_attention(q, kc, vc, pos, window=window)


def sharded_decode_attention(q, k, v, kc, vc, pos: int, tp, window=None):
    """One decode step over a cache whose sequence is split over
    ``model`` (the reference's ``kv_seq`` layout, its flash decoding):
    rank i holds slots [i S_loc, (i+1) S_loc) of every head.  Only the
    rank that owns the token's slot writes its K/V (at its local
    offset); each rank attends over its own keys through the flash
    kernel with the row's log-sum-exp, and the ranks' partial results
    are combined (``_combine_shards``).  q: (B, 1, H, Dh) of all heads.

    A contiguous cache holds position p at slot p, and key j of rank i
    is live iff i S_loc + j <= ``pos``.  A local-attention ring of
    ``window`` slots (the cache's whole length) holds position p at
    slot p % window: the last ``window`` positions once ``pos`` >=
    window - 1, every slot then live and within the window (the
    reference's ring decode attends every written slot), and slots 0 ..
    ``pos`` before, as a contiguous cache.  A rank none of whose keys
    is live contributes nothing."""
    s_loc = kc.shape[1]
    ring = window is not None and s_loc * tp.size == window
    base = tp.index * s_loc
    at = (pos % window if ring else pos) - base
    if 0 <= at < s_loc:
        kc[:, at] = k[:, 0].to(kc.dtype)
        vc[:, at] = v[:, 0].to(vc.dtype)
    off = (min(pos, window - 1) if ring else pos) - base
    B, _, H, Dh = q.shape
    if off >= 0:
        o, lse = flash_attention_lse(q, kc, vc, causal=True, q_offset=off)
    else:
        o = q.new_zeros(B, 1, H, Dh)
        lse = torch.full((B, H, 1), -math.inf, dtype=torch.float32,
                         device=q.device)
    return _combine_shards(o, lse, tp)


def _combine_shards(o, lse, tp):
    """The attention of one query row over a cache split along its
    sequence over ``model``, from each rank's partial (o (B, 1, H, Dh),
    its lse (B, H, 1)): one all-gather of every rank's (o, lse), packed;
    the partials softmax-weighted by their lse and added in rank order,
    so every rank gets the same bits."""
    Dh = o.shape[-1]
    got = all_gather(torch.cat([o.float()[:, 0], lse], -1)[None],
                     tp.mesh, MODEL, 0)                   # (m, B, H, Dh + 1)
    os_, ls = got[..., :Dh], got[..., Dh:]
    w = torch.exp(ls - ls.amax(0, keepdim=True))            # (m, B, H, 1)
    num, den = os_[0] * w[0], w[0]
    for i in range(1, got.shape[0]):
        num, den = num + os_[i] * w[i], den + w[i]
    return (num / den)[:, None].to(o.dtype)


def cross_attention_block(p, x, enc_kv, cfg, tp=None, step: bool = False):
    """Decoder cross-attention (whisper); ``enc_kv`` = (k, v) of the
    encoder output, (B, S_enc, KVH, Dh) each, attended whole (not
    causal) through the flash kernel (under grad with its backward
    kernel, Sq queries against S_enc keys).

    ``tp`` (on a mesh): with ``tp.heads`` this rank's q heads
    (column-parallel ``wq``, ``fanout_linear``) and a row-parallel
    ``wo``; ``enc_kv`` then holds this rank's heads
    (``encode_cross_kv``), except in a decode ``step``, whose cache
    holds every head: the row's q heads are gathered, every head
    attends, and this rank's go on.  A step's cache split along its
    frames (``tp.seq_shards``) is attended shard by shard and the
    partials combined (``_combine_shards``), with no causal mask.  With
    ``tp.seq`` x and the output are this rank's sequence shard, as in
    ``attention_block``."""
    if tp is not None and tp.seq and not tp.heads:
        return whole_sequence(lambda x, tp: cross_attention_block(
            p, x, enc_kv, cfg, tp), x, tp)
    split = tp is not None and tp.heads
    h = len(tp.head_range) if split else cfg.n_heads
    q = fanout_linear(x, p["wq"], tp=tp)[0] if split else linear(x, p["wq"])
    q = q.unflatten(-1, (h, cfg.head_dim)).contiguous()
    k, v = enc_kv
    if step and split:
        q = _gather_heads(tp, q)[0]
    if step and tp is not None and tp.seq_shards > 1:
        out = _combine_shards(*flash_attention_lse(q, k, v, causal=False),
                              tp)
    else:
        attend = (flash_attention_train if _needs_grad(q, k, v)
                  else flash_attention)
        out = attend(q, k, v, q_offset=0, causal=False)
    if step and split:
        out = out.narrow(2, tp.head_range.start, h)
    return out_proj(p, out, tp)


def encode_cross_kv(p, enc_out, cfg, tp=None):
    """The cross-attention K/V of one decoder layer from the encoder
    output (B, S_enc, D): computed once per prompt.  With ``tp.heads``
    this rank's heads: ``wk`` / ``wv`` column-parallel (or, where
    ``model`` does not divide KVH, only the KV heads its query heads
    read, repeated to them, as in ``project_qkv``), ``enc_out`` entering
    through ``fanout_linear`` at each use, so its gradient into the
    encoder is summed over ``model`` layer by layer.  With ``tp.seq``
    ``enc_out`` is this rank's shard of the frames, gathered first (by
    ``fanout_linear``, or whole where the heads do not split); the K/V
    hold every frame."""
    if tp is not None and tp.seq and not tp.heads:
        enc_out, tp = gather_sequence(enc_out, tp)
    ws = (p["wk"], p["wv"])
    split = tp is not None and tp.heads
    if split and not tp.kv:
        ws = _rank_kv_columns(cfg, tp, *ws)[:2]
    shape = (ws[0].shape[1] // cfg.head_dim, cfg.head_dim)
    k, v = (t.unflatten(-1, shape) for t in (
        fanout_linear(enc_out, *ws, tp=tp) if split
        else tuple(linear(enc_out, w) for w in ws)))
    if split and not tp.kv:
        k, v = (expand_kv(t, cfg.n_heads, cfg.n_kv_heads, tp.size,
                          tp.index) for t in (k, v))
    return k.contiguous(), v.contiguous()


def decode_attention(q, k_cache, v_cache, pos):
    """Single-token attention against a contiguous cache.

    q: (B, 1, H, Dh); caches: (B, S_max, KVH, Dh); ``pos``: tokens
    attendable (including the one just written), a host int or a 0-d
    tensor.  The cache IS a page pool of B pages of S_max tokens under
    the identity table, so this runs the paged kernel: the contiguous
    oracle and the paged engine share one kernel and one summation
    order."""
    B = q.shape[0]
    tables = torch.arange(B, dtype=torch.int32, device=q.device)[:, None]
    lengths = (decode_pos(pos, q.device) - 1).reshape(1).expand(B)
    return paged_attention(q, k_cache, v_cache, tables,
                           lengths.contiguous())


def flash_decode_layout(k_cache, v_cache, pos, window=None):
    """(k, v, q_offset) that ``flash_decode_attention`` gives the flash
    kernel for the query at position ``pos`` (a host int or a 0-d
    tensor; q_offset is a 0-d int32 tensor): a contiguous cache as it
    is, or a ring of ``window`` slots laid out in position order from
    the start of the 64-key tile that holds its oldest position
    (earlier slots of that tile hold newer keys, which the window
    masks).  The ring's layout has one length at every position,
    ``window + FLASH_TILE`` slots: before the ring wraps it starts at
    position 0, and the slots past ``pos`` (older or unwritten keys)
    are masked by causality, which leaves the row's bits as they are
    (the kernel's tiles are anchored at position 0, and keys past the
    row's are never added).  So the step has fixed shapes, and a CUDA
    graph replays it at any position."""
    pos = decode_pos(pos, k_cache.device)
    if window is None or k_cache.shape[1] != window:
        return k_cache, v_cache, pos
    base = (torch.clamp(pos + 1 - window, min=0)
            // FLASH_TILE * FLASH_TILE)
    idx = (base + torch.arange(window + FLASH_TILE,
                               device=k_cache.device)) % window
    return k_cache[:, idx], v_cache[:, idx], pos - base


def flash_decode_attention(q, k_cache, v_cache, pos, window=None):
    """The query at position ``pos`` (q (B, 1, H, Dh); a host int or a
    0-d tensor) against a contiguous cache holding positions 0 .. pos
    (B, S_max, KVH, Dh), or against a ring of ``window`` slots holding
    the last ``window`` positions at slot position % window, through the
    flash kernel.

    The kernel walks keys in tiles anchored at position 0 (a ring's
    layout keeps that anchoring), so the row gets the bits of row
    ``pos`` of a whole prefill over the same keys."""
    k, v, off = flash_decode_layout(k_cache, v_cache, pos, window)
    return flash_attention(q, k, v, q_offset=off, causal=True,
                           window=window)


def _tp_gather_heads(x, gather, dim: int):
    """Re-assemble a head- or hidden-sharded activation inside a
    tensor-parallel program (``serve/parallel.py``): ``gather(x, dim)``
    concatenates every shard's piece along ``dim`` in mesh order on
    the calling shard's device.  No cross-shard reduction ever runs,
    so shard i computes exactly the slice of every operation the
    single device computes for its heads.  ``gather=None`` (one
    device) is a no-op."""
    return x if gather is None else gather(x, dim)


def chunk_scatter_targets(starts, n_valid, table_rows, n_tokens: int,
                          page_size: int):
    """(page id, slot) write target of token t of row b (absolute
    position ``starts[b] + t``); padding tokens (t >= n_valid[b]) go to
    the null page 0.  Returns (pid, slot), both (B, n_tokens) int64."""
    t = torch.arange(n_tokens, device=starts.device)[None, :]
    abs_pos = starts.long()[:, None] + t
    nb = table_rows.shape[1]
    idx = torch.clamp(abs_pos // page_size, max=nb - 1)
    pid = torch.where(t < n_valid.long()[:, None],
                      torch.gather(table_rows.long(), 1, idx), 0)
    return pid, abs_pos % page_size


def verify_scatter_targets(lengths, page_table, n_tokens: int,
                           page_size: int):
    """(page id, slot) write target of token t of row b (absolute
    position ``lengths[b] + t``); a position past the end of the table
    goes to the null page instead of aliasing the row's last page.
    Returns (pid, slot), both (B, n_tokens) int64."""
    nb = page_table.shape[1]
    abs_pos = lengths.long()[:, None] + torch.arange(
        n_tokens, device=lengths.device)[None, :]
    idx = abs_pos // page_size
    pid = torch.where(idx < nb,
                      torch.gather(page_table.long(), 1,
                                   torch.clamp(idx, max=nb - 1)), 0)
    return pid, abs_pos % page_size


def paged_verify_attention_block(p, x, cfg, *, positions, k_pages,
                                 v_pages, page_table, lengths, gather=None):
    """Verification attention sub-layer (paged decode with a query-time
    axis).  x: (B, T, D), token t of row b at position
    ``lengths[b] + t``.  All T tokens' K/V are written into their page
    slots first (in place), then each query attends causally up to its
    own position.  T = 1 is the decode step (the reference's
    ``paged_attention_block``): one code path, so decode and verify at
    T = 1 agree by construction.  Under tensor parallelism (``gather``)
    this shard's heads are gathered before the replicated ``wo``."""
    B, T, _ = x.shape
    q, k, v = project_qkv(p, x, cfg, positions)
    pid, slot = verify_scatter_targets(lengths, page_table, T,
                                       k_pages.shape[1])
    k_pages[pid, slot] = k.to(k_pages.dtype)
    v_pages[pid, slot] = v.to(v_pages.dtype)
    out = paged_attention(q, k_pages, v_pages, page_table, lengths)
    return out_proj(p, _tp_gather_heads(out, gather, 2))


def paged_chunk_attention_block(p, x, cfg, *, positions, starts, n_valid,
                                k_pages, v_pages, table_rows, gather=None):
    """Batched chunked-prefill attention sub-layer over the page pool.

    x: (B, C, D), token t of row b at position ``starts[b] + t``;
    tokens t >= n_valid[b] are padding.  Each row's context is gathered
    from its table into a contiguous (nb * ps + C) buffer, the chunk's
    own K/V overlaid at the row's offset, and attention runs through
    the flash kernel with a per-row ``q_offset`` — the same anchored
    partition as whole-prompt prefill, so each row is bit-identical to
    it.  The chunk's K/V is then persisted into the pool in place
    (padding to the null page).  ``gather`` as in
    ``paged_verify_attention_block``."""
    B, C, _ = x.shape
    q, k, v = project_qkv(p, x, cfg, positions)
    nb = table_rows.shape[1]
    ps = k_pages.shape[1]
    rows = table_rows.long()
    idx = starts.long()[:, None] + torch.arange(C, device=x.device)[None]
    bidx = torch.arange(B, device=x.device)[:, None]
    bufs = []
    for pages, new in ((k_pages, k), (v_pages, v)):
        buf = pages[rows].reshape(B, nb * ps, *pages.shape[2:])
        buf = F.pad(buf, (0, 0, 0, 0, 0, C))
        buf[bidx, idx] = new.to(buf.dtype)
        bufs.append(buf)
    out = flash_attention(q, bufs[0], bufs[1], q_offset=starts.int(),
                          causal=True)
    pid, slot = chunk_scatter_targets(starts, n_valid, table_rows, C, ps)
    k_pages[pid, slot] = k.to(k_pages.dtype)
    v_pages[pid, slot] = v.to(v_pages.dtype)
    return out_proj(p, _tp_gather_heads(out, gather, 2))


# ------------------------------------------------------------------ mlp
def mlp_specs(cfg, d_ff=None) -> dict:
    """A dense FFN of width ``d_ff`` (default ``cfg.d_ff``; a leading
    dense layer of an MoE stack takes ``moe.dense_d_ff``)."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.mlp_kind == "gelu":
        return {"w1": ParamSpec((d, f), ("embed", "ff")),
                "b1": ParamSpec((f,), ("stats",), init=zeros),
                "w2": ParamSpec((f, d), ("ff", "embed")),
                "b2": ParamSpec((d,), ("stats",), init=zeros)}
    return {"wg": ParamSpec((d, f), ("embed", "ff")),
            "wu": ParamSpec((d, f), ("embed", "ff")),
            "wd": ParamSpec((f, d), ("ff", "embed"))}


def mlp_block(p, x, cfg, gather=None, tp=None):
    """Dense FFN in the compute dtype: SwiGLU silu(x Wg) * (x Wu) Wd, or
    GELU (tanh approximation, ``jax.nn.gelu``'s default) with biases.
    Under tensor-parallel serving (``gather``) the up projections hold
    this shard's slice of the hidden dim, which is gathered
    (concatenated, not reduced) before the replicated down projection.
    On a training mesh with ``tp.ff`` the up projections are column-
    and the down projection row-parallel over ``model``
    (``row_parallel``: f32 partials summed, rounded once); with
    ``tp.seq`` x and the output are this rank's sequence shard (a split
    FFN gathers x and reduce-scatters its sum, a whole one runs on the
    whole sequence: ``whole_sequence``)."""
    if tp is not None and tp.seq and not tp.ff:
        return whole_sequence(lambda x, tp: mlp_block(p, x, cfg, tp=tp), x,
                              tp)
    if tp is not None and tp.ff:
        return _mlp_split(p, x, cfg, tp)
    if cfg.mlp_kind == "gelu":
        h = F.gelu(linear(x, p["w1"], p["b1"]), approximate="tanh")
        return linear(_tp_gather_heads(h, gather, -1), p["w2"], p["b2"],
                      last=True)
    g = F.silu(linear(x, p["wg"]))
    h = _tp_gather_heads(g * linear(x, p["wu"]), gather, -1)
    return linear(h, p["wd"], last=True)


def _mlp_split(p, x, cfg, tp):
    """The FFN over this rank's hidden slice (x through
    ``fanout_linear``)."""
    if cfg.mlp_kind == "gelu":
        w1 = p["w1"]
        h = _add_bias(fanout_linear(x, w1, tp=tp)[0],
                      rank_slice(p["b1"], tp, w1.shape[1]))
        h = F.gelu(h, approximate="tanh")
        # under tp.seq b2 is added on the rank's rows: its gradient is
        # summed over model (fanout_tree)
        return (row_parallel(h, p["w2"], tp, last=True)
                + fanout_tree(p["b2"], tp).to(x.dtype))
    g, u = fanout_linear(x, p["wg"], p["wu"], tp=tp)
    return row_parallel(F.silu(g) * u, p["wd"], tp, last=True)


# ------------------------------------------------------------------ moe
def moe_specs(cfg) -> dict:
    m = cfg.moe
    d, fe, e = cfg.d_model, m.d_expert_ff, m.n_experts
    p = {"router": ParamSpec((d, e), ("embed", None), init=normal(0.02),
                             f32=True),
         "wg": ParamSpec((e, d, fe), ("expert", "embed", "expert_ff")),
         "wu": ParamSpec((e, d, fe), ("expert", "embed", "expert_ff")),
         "wd": ParamSpec((e, fe, d), ("expert", "expert_ff", "embed"))}
    if m.n_shared:
        fs = fe * m.n_shared
        p["shared"] = {"wg": ParamSpec((d, fs), ("embed", "ff")),
                       "wu": ParamSpec((d, fs), ("embed", "ff")),
                       "wd": ParamSpec((fs, d), ("ff", "embed"))}
    return p


def moe_capacity(n_tokens: int, m) -> int:
    """Slots per expert for a call of ``n_tokens`` rows (padding rows
    included, as the reference counts them)."""
    c = int(n_tokens * m.top_k / m.n_experts * m.capacity_factor)
    return max(1, min(c, n_tokens))


def moe_route(p, xf, cfg):
    """Router of (T, D) tokens in f32: (probs (T, E), gate weights
    (T, K), expert ids (T, K) int64).  The top k come from a stable
    descending sort, so ties go to the lower expert id, as
    ``lax.top_k``'s do."""
    m = cfg.moe
    probs = torch.softmax(linear(xf.float(), p["router"]), dim=-1)
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = topw[:, :m.top_k], topi[:, :m.top_k]
    if m.normalize_router:
        topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    return probs, topw, topi


class _RepeatRows(torch.autograd.Function):
    """(T, D) -> (T * K, D), each row repeated K times (the dispatch's
    ``xf[tok]``); the backward adds a row's K gradients in choice order,
    one rounded add at a time, as the forward adds the K outputs.  An
    index's backward would leave that order to a library kernel."""

    @staticmethod
    def forward(ctx, xf, k):
        ctx.k = k
        return xf.repeat_interleave(k, dim=0)

    @staticmethod
    def backward(ctx, g):
        g = g.reshape(-1, ctx.k, g.shape[-1])
        out = g[:, 0]
        for i in range(1, ctx.k):
            out = out + g[:, i]
        return out, None


def moe_block(p, x, cfg, tp=None):
    """Mixture of experts: the reference's ``_moe_compute``, on one
    device (``ep_size = 1``) or expert-parallel on a mesh.  x: (B, S,
    D) -> (y (B, S, D), the Switch load-balance aux loss of this call's
    tokens).

    With ``tp.experts`` this rank owns E / m experts (its ``model``
    index ``ep_index``) and their weights: it routes its own tokens
    (the router whole, as every rank of ``model`` does), dispatches only
    the (token, choice) pairs that land on its experts, with the
    capacity of its own token count, and returns the sum over ``model``
    of every rank's partial output (``_moe_partial``), the shared
    expert's row-parallel partial (``tp.shared``) added before the one
    f32 sum.  An expert's slots are counted over the pairs routed to it
    in token order, so a rank's dispatch is the single-device dispatch
    restricted to its experts.

    With ``tp.seq`` x (B, S / m, D) is this rank's sequence shard: it is
    all-gathered first, so routing and capacity see the whole call's
    rows, as without sequence parallelism; the experts' and the shared
    expert's sums are reduce-scattered along the sequence
    (``model_sum``) and duplicated outputs cut to the rank's rows
    (``model_rows``).  Between the two the block computes what it
    computes without sequence parallelism (``tp`` with ``seq`` off)."""
    m = cfg.moe
    outer = tp
    if tp is not None and tp.seq:
        x, tp = gather_sequence(x, tp)
    B, S, D = x.shape
    xf = x.reshape(B * S, D)
    probs, topw, topi = moe_route(p, xf, cfg)
    ep = tp is not None and tp.experts
    # the inputs of split work enter through fanout: the router's are
    # the whole work of every rank
    xe, gate = ((fanout(xf, tp.mesh, MODEL), fanout(topw, tp.mesh, MODEL))
                if ep else (xf, topw))
    y = _moe_partial(p, xe, gate, topi, cfg,
                     tp.size if ep else 1,
                     tp.index if ep else 0).reshape(B, S, D)
    if m.n_shared:
        sp = p["shared"]
        split = tp is not None and tp.shared
        g, u = (fanout_linear(xf, sp["wg"], sp["wu"], tp=tp) if split
                else (linear(xf, sp["wg"]), linear(xf, sp["wu"])))
        h = F.silu(g) * u
        if split:
            sh = linear(h, sp["wd"], f32_out=True,
                        last=True).reshape(B, S, D)
            y = (model_sum(y.float() + sh, outer) if ep else
                 model_rows(y, outer) + model_sum(sh, outer).to(x.dtype))
        else:
            y = ((model_sum(y.float(), outer).to(x.dtype) if ep
                  else model_rows(y, outer))
                 + model_rows(linear(h, sp["wd"], last=True)
                              .reshape(B, S, D), outer))
    elif ep:
        y = model_sum(y.float(), outer)
    else:
        y = model_rows(y, outer)
    E = m.n_experts
    me = probs.mean(dim=0)
    ce = (topi[:, :1] == torch.arange(E, device=topi.device)
          ).float().mean(dim=0)                  # one-hot, as above
    return y.to(x.dtype), E * torch.sum(me * ce)


def _moe_partial(p, xf, topw, topi, cfg, ep_size: int = 1,
                ep_index: int = 0):
    """The experts' part of the reference's ``_moe_compute(p, x, cfg,
    ep_size, ep_index)``: (T, D) tokens with their gate weights and
    expert ids (T, K) -> the gate-weighted outputs (T, D) of the (token,
    choice) pairs that land on the ``E / ep_size`` experts this shard
    owns (``p``'s expert weights are those experts').

    Every pair takes the next free slot of its expert in token order;
    pairs past an expert's capacity C (counted from T, as the
    reference counts it) are dropped: they are written to a spare slot
    C that no product reads, and read back from a zero row there, as
    are the pairs of other shards' experts.  The experts' SwiGLU runs
    as (E_loc, C, D) batched products in the compute dtype; the
    gate-weighted outputs are added back per token in choice order.
    Under grad a token's K dispatched copies send their gradients back
    added in choice order too (``_RepeatRows``), and the gathers'
    backwards write each slot once, so a row's gradient bits rest on
    no library's choice of order; the experts' products stay
    ``torch.bmm`` (the reference's ``einsum``s)."""
    m = cfg.moe
    T, D = xf.shape
    K = m.top_k
    e_loc = m.n_experts // ep_size
    C = moe_capacity(T, m)
    eid = topi.reshape(-1)                                   # (T*K,)
    gate = topw.reshape(-1)
    lid = eid - ep_index * e_loc
    mine = (lid >= 0) & (lid < e_loc)
    lid = torch.where(mine, lid, 0)
    # one-hot by comparison: F.one_hot checks the ids' range on the
    # host on the CPU, and a captured program reads no value (the CUDA
    # graphs' CPU stand-in holds the program to that)
    onehot = (lid[:, None] == torch.arange(e_loc, device=lid.device)
              ).long() * mine[:, None]
    pos = torch.cumsum(onehot, dim=0) - onehot
    pos = torch.gather(pos, 1, lid[:, None])[:, 0]
    pos = torch.where(mine & (pos < C), pos, C)              # C: dropped
    x_e = xf.new_zeros(e_loc, C + 1, D)
    x_e[lid, pos] = _RepeatRows.apply(xf, K)
    x_e = x_e[:, :C]
    g = F.silu(torch.bmm(x_e, p["wg"].to(xf.dtype)))
    u = torch.bmm(x_e, p["wu"].to(xf.dtype))
    y_e = F.pad(torch.bmm(g * u, p["wd"].to(xf.dtype)), (0, 0, 0, 1))
    # each token's K gate-weighted outputs summed in choice order, one
    # rounded add at a time from zero (the reference's scatter-add
    # order); an atomic index_add_ would sum them in whatever order
    # the card's threads arrive, so a row's bits would depend on the
    # other rows of its call and differ between runs
    y_k = (y_e[lid, pos] * gate[:, None].to(xf.dtype)).reshape(T, K, D)
    y = xf.new_zeros(T, D)
    for k in range(K):
        y = y + y_k[:, k]
    return y


# ----------------------------------------------------------- embeddings
def embed_specs(cfg) -> dict:
    p = {"tok": ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                          init=normal(0.02))}
    if not cfg.tie_embeddings:
        p["head"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                              ("embed", "vocab"))
    return p


def embed_tokens(p, tokens, cfg, dtype, tp=None):
    """Token embeddings in ``dtype``.  With ``tp.vocab`` the table holds
    this rank's vocabulary slice: each rank looks up the tokens it owns
    (zeros elsewhere) and the ranks' rows are summed over ``model``,
    one non-zero term each, so the sum is the row itself.  With
    ``tp.seq`` the result is this rank's sequence rows: the vocabulary
    slices' sum reduce-scattered, or a whole table's lookup cut
    (``model_rows``)."""
    # F.embedding: the gather's bits, and a backward that sums a
    # repeated token's gradients in a fixed order on the card
    tok = tokens.long()
    if tp is not None and tp.vocab:
        n = p["tok"].shape[0]
        local = tok - tp.index * n
        mine = (local >= 0) & (local < n)
        x = F.embedding(torch.where(mine, local, 0), p["tok"])
        x = torch.where(mine[..., None], x, 0).to(dtype)
        x = model_sum(x, tp)
    else:
        x = model_rows(F.embedding(tok, p["tok"]).to(dtype), tp)
    if cfg.scale_embeddings:
        x = x * math.sqrt(cfg.d_model)
    return x


#: rows per unembedding product (see ``unembed``)
UNEMBED_ROWS = 64


def unembed(p, x, cfg, tp=None):
    """Unembedding in f32: (..., D) -> (..., V), through the tied
    embedding table or the untied ``head``, soft-capped as
    ``c tanh(logits / c)`` when the config sets ``logit_softcap``.

    The rows go through the f32 product in tiles of UNEMBED_ROWS, the
    last one zero-padded, so every product has the same shape.  A BLAS
    picks its kernel, and with it the summation order, by the number of
    rows (measured on the CPU: an f32 product gives a row other bits at
    1, 2 or up to 15 rows than at more), so a row's logits would
    otherwise depend on how many rows share the call, and the engine's
    logits would not match the oracle's bit for bit.  Training needs no
    such row independence: under grad the rows go through one product,
    which is deterministic at a fixed shape.

    With ``tp.vocab`` each rank computes its vocabulary slice
    (``unembed_local``) and the slices are gathered over ``model``."""
    if tp is not None and tp.vocab:
        return gather(unembed_local(p, x, cfg, tp), tp.mesh, MODEL,
                      x.dim() - 1, split=False)
    return _unembed(p, x, cfg)


def unembed_local(p, x, cfg, tp):
    """This rank's vocabulary slice of the logits, (..., V / m), x
    entering through ``fanout`` (every rank's slice reads it) in f32,
    so its gradient's f32 partials are summed before their one
    rounding."""
    return _unembed(p, fanout(x.float(), tp.mesh, MODEL), cfg)


def _unembed(p, x, cfg):
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).float()
    M = x2.shape[0]
    w = (p["tok"].t() if cfg.tie_embeddings else p["head"]).float()
    if _needs_grad(x2, w):
        logits = x2 @ w
    else:
        pad = -M % UNEMBED_ROWS
        if pad:
            x2 = torch.cat([x2, x2.new_zeros(pad, x2.shape[1])])
        logits = torch.empty(M + pad, w.shape[1], dtype=torch.float32,
                             device=x.device)
        for i in range(0, M + pad, UNEMBED_ROWS):
            torch.matmul(x2[i:i + UNEMBED_ROWS], w,
                         out=logits[i:i + UNEMBED_ROWS])
        logits = logits[:M]
    logits = logits.reshape(*lead, -1)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits
