"""Loss and train step of the port: the reference's
``repro.train.step`` in PyTorch.

Parameters are leaf tensors stored in ``cfg.param_dtype`` (f32, or
bf16 for every leaf of 2 or more dimensions: ``models/base.py:
with_param_dtype``).  ``cast_params_for_compute`` casts the f32 leaves
with ``ndim >= 2`` to the compute dtype before the model sees them (on
the stacked tree, as the reference does), so the gradients reach the
leaves through the cast; a bf16 leaf's gradient is bf16, and AdamW
with ``keep_master`` updates its f32 master copy.  The gradient comes from
autograd over the model's training forward (``DecoderLM.apply(...,
train=True)``): on the card every projection's backward runs on the
dataflow GEMM and the attention's on its backward kernel, so a step is
a deterministic function of (params, opt_state, batch).

The loss is the reference's: the token NLL (chunked over the sequence
when ``cfg.loss_chunk > 0``, except for an encoder-decoder) plus
``cfg.moe.aux_coef`` times the MoE layers' load-balance loss.  Every
architecture the reference trains trains here.

Gradient accumulation over microbatches sums in ``grad_accum_dtype``,
one microbatch at a time (the reference's ``lax.scan``).

**On a mesh** (``with mesh:``) the parameters, optimizer state and
batch are the rank's shards.  The loss is the mean over every rank's
tokens: each rank scales its own mean by 1 / (data ranks) before the
backward, the FSDP gathers' reduce-scatters sum the data-sharded
leaves' gradients, and every other leaf's gradient is summed over the
data axes after the backward.  The cross-entropy is vocab-parallel
(``vocab_parallel_nll``) where ``model`` splits the vocabulary.  With
``n_micro`` each rank splits its own rows, so the token groups an MoE
routes (its capacity and aux loss are per group) are the single-device
step's at ``n_micro`` x (data ranks) microbatches.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..launch.mesh import current_mesh
from ..sharding.collectives import all_reduce
from ..sharding.rules import spec_axes
from ..sharding.spmd import MODEL
from ..tree import tree_items, tree_leaves, tree_map, tree_unflatten
from .optimizer import OptConfig, adamw_update

__all__ = ["cross_entropy", "chunked_cross_entropy", "vocab_parallel_nll",
           "cast_params_for_compute", "make_loss_fn", "make_grad_fn",
           "make_train_step", "auto_microbatches"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def cross_entropy(logits, labels):
    """Mean token NLL.  logits f32 (B, S, V); labels int (B, S)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


def chunked_cross_entropy(hidden, embed_params, labels, cfg, chunk: int):
    """Sequence-chunked CE: per chunk, project -> logsumexp -> discard,
    each chunk under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint``), so the (B, S, V) logits never exist at once."""
    w = (embed_params["tok"].t() if cfg.tie_embeddings
         else embed_params["head"])
    B, S, _ = hidden.shape
    chunk = min(chunk, S)
    while S % chunk:
        chunk -= 1

    def chunk_nll(hc, lc):
        logits = hc.float() @ w.float()
        if cfg.logit_softcap:
            c = cfg.logit_softcap
            logits = c * torch.tanh(logits / c)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lc.long()[..., None])[..., 0]
        return (logz - gold).sum()

    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for s0 in range(0, S, chunk):
        tot = tot + checkpoint(chunk_nll, hidden[:, s0:s0 + chunk],
                               labels[:, s0:s0 + chunk], use_reentrant=False)
    return tot / (B * S)


class _VocabParallelNLL(torch.autograd.Function):
    """Token NLL of logits whose vocabulary is split over ``model``:
    the row maximum, the sum of exponentials and the target logit each
    summed (the maximum: maxed) over ``model``; backward softmax minus
    the target's one-hot, on this rank's slice."""

    @staticmethod
    def forward(ctx, logits, labels, start: int, mesh):
        n = logits.shape[-1]
        mx = all_reduce(logits.detach().amax(-1), mesh, MODEL,
                        op=torch.distributed.ReduceOp.MAX)
        e = torch.exp(logits - mx[:, None])
        se = all_reduce(e.sum(-1), mesh, MODEL)
        local = labels.long() - start
        mine = (local >= 0) & (local < n)
        idx = torch.where(mine, local, 0)
        tgt = torch.where(mine, torch.gather(logits, -1, idx[:, None])[:, 0],
                          0.0)
        tgt = all_reduce(tgt, mesh, MODEL)
        ctx.save_for_backward(e, se, idx, mine)
        return torch.log(se) + mx - tgt

    @staticmethod
    def backward(ctx, g):
        e, se, idx, mine = ctx.saved_tensors
        grad = e / se[:, None]
        rows = torch.arange(idx.shape[0], device=idx.device)
        grad[rows, idx] -= mine.to(grad.dtype)
        return grad * g[:, None], None, None, None


def vocab_parallel_nll(logits, labels, start: int, mesh):
    """(N,) token NLL of this rank's vocabulary slice of the logits
    (N, V / m), starting at vocabulary id ``start``."""
    return _VocabParallelNLL.apply(logits, labels, start, mesh)


def _mesh_nll_sum(model, params, hidden, labels, mesh):
    """The sum of the token NLL of (B, S, D) hidden states: the
    vocab-parallel NLL where ``model`` splits the vocabulary, else the
    whole logits' (``cross_entropy``'s terms)."""
    logits, start = model.unembed_local(params, hidden)
    if logits.shape[-1] == model.cfg.vocab_size:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        return (logz - gold).sum()
    return vocab_parallel_nll(logits.reshape(-1, logits.shape[-1]),
                              labels.reshape(-1), start, mesh).sum()


def _mesh_loss(model, params, hidden, labels, chunk: int, mesh):
    """The mean token NLL on a mesh: over the whole sequence, or per
    ``chunk`` of it under ``torch.utils.checkpoint``."""
    B, S, _ = hidden.shape
    if chunk <= 0:
        return _mesh_nll_sum(model, params, hidden, labels, mesh) / (B * S)
    chunk = min(chunk, S)
    while S % chunk:
        chunk -= 1
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for s0 in range(0, S, chunk):
        tot = tot + checkpoint(
            lambda h, lab: _mesh_nll_sum(model, params, h, lab, mesh),
            hidden[:, s0:s0 + chunk], labels[:, s0:s0 + chunk],
            use_reentrant=False)
    return tot / (B * S)


def cast_params_for_compute(params, dtype=torch.bfloat16):
    """f32 leaves with ``ndim >= 2`` cast to the compute dtype (a
    differentiable cast); the rest as they are."""
    def cast(p):
        if p.dtype == torch.float32 and p.dim() >= 2:
            return p.to(dtype)
        return p
    return tree_map(cast, params)


def make_loss_fn(model, cfg) -> Callable:
    """``loss_fn(params, batch) -> (loss, {"nll", "moe_aux"})``."""
    aux_coef = cfg.moe.aux_coef if cfg.moe is not None else 0.0
    chunked = cfg.loss_chunk > 0 and not cfg.is_encoder_decoder
    dtype = _DTYPES[cfg.compute_dtype]

    def loss_fn(params, batch):
        params = cast_params_for_compute(params, dtype)
        mesh = current_mesh()
        if mesh is not None and (mesh.axis_size(MODEL) > 1 or chunked):
            hidden, aux = model.apply(params, batch, train=True,
                                      want_hidden=True, want_aux=True)
            nll = _mesh_loss(model, params, hidden, batch["labels"],
                             cfg.loss_chunk if chunked else 0, mesh)
        elif chunked:
            hidden, aux = model.apply(params, batch, train=True,
                                      want_hidden=True, want_aux=True)
            nll = chunked_cross_entropy(hidden, params["embed"],
                                        batch["labels"], cfg,
                                        cfg.loss_chunk)
        else:
            logits, aux = model.apply(params, batch, train=True,
                                      want_aux=True)
            nll = cross_entropy(logits, batch["labels"])
        loss = nll + aux_coef * aux["moe_aux"]
        return loss, {"nll": nll, "moe_aux": aux["moe_aux"]}
    return loss_fn


def auto_microbatches(cfg, batch: int, seq: int, dp: int,
                      budget_bytes: float = 2.5e9) -> int:
    """Grad-accumulation steps so one microbatch's residual-stream
    activations per device stay under ``budget_bytes`` (the reference's
    rule, answer for answer):

        bytes/device ~= (B_u/dp) * S * d_model * 2 (bf16) * n_layers

    The microbatch size stays divisible by dp."""
    if cfg.train_microbatch:
        return cfg.train_microbatch
    n_micro = 1
    while True:
        b_u = batch // n_micro
        if b_u <= dp or b_u % dp:
            break
        per_dev = (b_u / dp) * seq * cfg.d_model * 2 * max(cfg.n_layers, 1)
        if per_dev <= budget_bytes:
            break
        n_micro *= 2
    while batch % n_micro or (batch // n_micro) % dp:
        n_micro //= 2
    return max(n_micro, 1)


def _compress_generator(device, step: int) -> torch.Generator:
    """The int8 compression's noise source of one step, seeded from
    (17, step)."""
    seed = int(np.random.SeedSequence([17, step]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(seed)


def _sum_over_data(grads, shardings, mesh, dp):
    """Each leaf's gradient summed over the data axes it is not stored
    over (its FSDP gathers' reduce-scatters summed the others)."""
    out = []
    for g, (_, spec) in zip(grads, tree_items(shardings)):
        used = {a for e in spec for a in spec_axes(e)}
        rest = tuple(a for a in dp if a not in used)
        out.append(all_reduce(g, mesh, rest) if rest else g)
    return out


def _shardings(model, mesh):
    """The parameters' ``logical_spec`` tuples on ``mesh``."""
    return tree_map(lambda pl: pl[0], model.placement(mesh))


def make_grad_fn(model, cfg, *, n_micro: int = 1) -> Callable:
    """``grad_fn(params, batch) -> (loss, {"nll", "moe_aux"}, grads)``:
    the train step's loss and gradient (a list in ``tree_leaves``
    order, each leaf's in its storage dtype), accumulated over
    ``n_micro`` microbatches; on a mesh the rank's gradient shards of
    the whole batch's loss, and the whole batch's metrics."""
    loss_fn = make_loss_fn(model, cfg)
    acc_dt = _DTYPES[cfg.grad_accum_dtype]

    def grads_of(leaves, params, batch, scale):
        with torch.enable_grad():
            loss, aux = loss_fn(params, batch)
            grads = torch.autograd.grad(
                loss if scale == 1 else loss * scale, leaves)
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads

    def grad_fn(params, batch):
        mesh = current_mesh()
        scale = 1
        if mesh is not None:
            dp = mesh.data_axes()
            scale = 1 / mesh.axis_size(dp)
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        wparams = tree_unflatten(params, leaves)
        if n_micro == 1:
            loss, aux, grads = grads_of(leaves, wparams, batch, scale)
        else:
            b = next(iter(batch.values())).shape[0]
            if b % n_micro:
                raise ValueError(f"batch {b} does not split into "
                                 f"{n_micro} microbatches")
            u = b // n_micro
            gsum = [torch.zeros(p.shape, dtype=acc_dt, device=p.device)
                    for p in leaves]
            lsum = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            for i in range(n_micro):
                mb = {k: v[i * u:(i + 1) * u] for k, v in batch.items()}
                loss, _, g = grads_of(leaves, wparams, mb, scale)
                gsum = [a + c.to(a.dtype) for a, c in zip(gsum, g)]
                lsum = lsum + loss
            grads = [g / n_micro for g in gsum]
            loss = lsum / n_micro
            aux = {"nll": loss, "moe_aux": torch.zeros_like(loss)}
        if mesh is not None:
            grads = _sum_over_data(grads, _shardings(model, mesh), mesh, dp)
            loss = all_reduce(loss, mesh, dp) * scale
            aux = {k: all_reduce(v, mesh, dp) * scale
                   for k, v in aux.items()}
        return loss, aux, list(grads)
    return grad_fn


def make_train_step(model, cfg, *, opt: OptConfig = OptConfig(),
                    n_micro: int = 1) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.  Every batch leaf has the batch dim at axis 0; ``params``
    are tensors in their storage dtypes (leaves or not: the step takes
    its gradient with respect to detached copies that require it).
    Called under ``with mesh:`` it is the mesh's step (module
    docstring); the metrics are the whole batch's."""
    grad_fn = make_grad_fn(model, cfg, n_micro=n_micro)

    def train_step(params, opt_state, batch):
        loss, aux, grads = grad_fn(params, batch)
        mesh = current_mesh()
        shardings = None if mesh is None else _shardings(model, mesh)
        gen = (_compress_generator(grads[0].device, int(opt_state["step"]))
               if opt.compress_grads else None)
        params, opt_state, om = adamw_update(
            params, tree_unflatten(params, grads), opt_state, opt,
            compress_gen=gen, shardings=shardings)
        return params, opt_state, {"loss": loss, **aux, **om}

    return train_step
