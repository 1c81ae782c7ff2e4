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
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..tree import tree_leaves, tree_map, tree_unflatten
from .optimizer import OptConfig, adamw_update

__all__ = ["cross_entropy", "chunked_cross_entropy",
           "cast_params_for_compute", "make_loss_fn", "make_train_step",
           "auto_microbatches"]

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
        if chunked:
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


def make_train_step(model, cfg, *, opt: OptConfig = OptConfig(),
                    n_micro: int = 1) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.  Every batch leaf has the batch dim at axis 0; ``params``
    are tensors in their storage dtypes (leaves or not: the step takes
    its gradient with respect to detached copies that require it)."""
    loss_fn = make_loss_fn(model, cfg)
    acc_dt = _DTYPES[cfg.grad_accum_dtype]

    def grads_of(leaves, params, batch):
        with torch.enable_grad():
            loss, aux = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads

    def train_step(params, opt_state, batch):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        wparams = tree_unflatten(params, leaves)
        if n_micro == 1:
            loss, aux, grads = grads_of(leaves, wparams, batch)
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
                loss, _, g = grads_of(leaves, wparams, mb)
                gsum = [a + c.to(a.dtype) for a, c in zip(gsum, g)]
                lsum = lsum + loss
            grads = [g / n_micro for g in gsum]
            loss = lsum / n_micro
            aux = {"nll": loss, "moe_aux": torch.zeros_like(loss)}
        gen = (_compress_generator(leaves[0].device, int(opt_state["step"]))
               if opt.compress_grads else None)
        params, opt_state, om = adamw_update(
            params, tree_unflatten(params, grads), opt_state, opt,
            compress_gen=gen)
        return params, opt_state, {"loss": loss, **aux, **om}

    return train_step
