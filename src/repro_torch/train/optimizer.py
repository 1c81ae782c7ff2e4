"""AdamW with global-norm clipping and optional int8 gradient
compression with error feedback: the reference's
``repro.train.optimizer``, on nested dicts of tensors.

The arithmetic is the reference's, in f32, leaf for leaf: linear
warmup, bias-corrected moments, weight decay only on leaves with
``ndim >= 2`` of the tree as stored.  The stored tree is stacked (every
scanned layer's leaf carries a leading layer axis, ``models/lm.py``), so
the stacked norm scales ``(L, D)`` are decayed and the final norm's
``(D,)`` is not, exactly as in the reference.

``compress_int8`` rounds stochastically with noise from a
``torch.Generator``; ``train/step.py`` seeds it from (17, step), where
the reference folds the step into ``PRNGKey(17)``.  The two generators
give different numbers, so compressed steps agree with the reference in
distribution, not in bits.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..tree import tree_items, tree_leaves, tree_map, tree_unflatten

__all__ = ["OptConfig", "init_opt_state", "adamw_update",
           "clip_by_global_norm", "compress_int8", "decompress_int8"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    # int8 stochastic-rounding gradient compression; the error-feedback
    # residual is carried in the opt state
    compress_grads: bool = False
    # bf16 param storage: keep the f32 master copy in the opt state
    keep_master: bool = False


def _zeros(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def init_opt_state(params, cfg: OptConfig = OptConfig()):
    """``{"mu", "nu"}`` (f32 zeros shaped like ``params``), ``"step"``
    (an int32 scalar on the parameters' device) and, as configured,
    ``"ef"`` and ``"master"``."""
    device = tree_leaves(params)[0].device
    state = {"mu": tree_map(_zeros, params),
             "nu": tree_map(_zeros, params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    if cfg.compress_grads:
        state["ef"] = tree_map(_zeros, params)
    if cfg.keep_master:
        state["master"] = tree_map(lambda p: p.detach().float().clone(),
                                   params)
    return state


def _clip_scale(grads, max_norm: float):
    """(the global L2 norm, the factor that scales it to at most
    ``max_norm``); the norm sums the leaves' squares in tree order, as
    the reference's Python ``sum`` does."""
    gn = None
    for g in tree_leaves(grads):
        s = torch.sum(torch.square(g.float()))
        gn = s if gn is None else gn + s
    gn = torch.sqrt(gn)
    return gn, torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global L2 norm of at most ``max_norm``, the
    norm before clipping)."""
    with torch.no_grad():
        gn, scale = _clip_scale(grads, max_norm)
        return tree_map(lambda g: g * scale, grads), gn


def _lr_at(cfg: OptConfig, step):
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def compress_int8(g, generator: torch.Generator):
    """Stochastic-rounding int8 quantization; returns (q, scale)."""
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    noise = torch.rand(g.shape, generator=generator, dtype=torch.float32,
                       device=g.device) - 0.5
    q = torch.clamp(torch.round(g / scale + noise), -127, 127)
    return q.to(torch.int8), scale


def decompress_int8(q, scale):
    return q.float() * scale


def adamw_update(params, grads, state, cfg: OptConfig = OptConfig(),
                 compress_gen: Optional[torch.Generator] = None):
    """One AdamW step.  Returns (params, state, metrics): new trees (the
    inputs are not modified), ``metrics`` with ``grad_norm`` and ``lr``.
    With ``cfg.compress_grads`` the gradients pass through int8 with
    error feedback first, each leaf's noise drawn from ``compress_gen``
    in tree order."""
    with torch.no_grad():
        return _adamw(params, grads, state, cfg, compress_gen)


def _adamw(params, grads, state, cfg, compress_gen):
    step = state["step"]
    metrics: dict[str, Any] = {}
    if cfg.compress_grads:
        if compress_gen is None:
            raise ValueError("compress_grads needs a compress_gen")
        # error-feedback int8: quantize (grad + residual); the residual
        # keeps what quantization lost
        pairs = []
        for (_, g), e in zip(tree_items(grads), tree_leaves(state["ef"])):
            full = g.float() + e
            deq = decompress_int8(*compress_int8(full, compress_gen))
            pairs.append((deq, full - deq))
        grads = tree_unflatten(grads, [d for d, _ in pairs])
        new_ef = tree_unflatten(grads, [r for _, r in pairs])
    # the clip's scale is applied leaf by leaf in ``upd`` (the same
    # product as ``clip_by_global_norm``'s), so no clipped copy of the
    # whole gradient tree is held beside it
    gnorm, scale = _clip_scale(grads, cfg.grad_clip)
    metrics["grad_norm"] = gnorm
    lr = _lr_at(cfg, step)
    metrics["lr"] = lr
    b1, b2 = cfg.b1, cfg.b2
    base = state.get("master", params)   # f32 master when params are bf16

    def upd(p, b, g, mu, nu):
        g = (g * scale).float()
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * torch.square(g)
        mu_hat = mu / (1 - b1 ** (step + 1))
        nu_hat = nu / (1 - b2 ** (step + 1))
        delta = mu_hat / (torch.sqrt(nu_hat) + cfg.eps)
        if cfg.weight_decay and p.dim() >= 2:     # no decay on norms/bias
            delta = delta + cfg.weight_decay * b.float()
        nb = b.float() - lr * delta
        return nb.to(p.dtype), nb, mu, nu

    quads = tree_map(upd, params, base, grads, state["mu"], state["nu"])

    def pick(i):
        return tree_map(lambda t: t[i], quads)
    new_state = {"mu": pick(2), "nu": pick(3), "step": step + 1}
    if cfg.keep_master:
        new_state["master"] = pick(1)
    if cfg.compress_grads:
        new_state["ef"] = new_ef
    return pick(0), new_state, metrics
