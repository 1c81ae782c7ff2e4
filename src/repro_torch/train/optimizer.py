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

from ..launch.mesh import current_mesh
from ..sharding.collectives import all_reduce
from ..sharding.rules import spec_axes
from ..tree import tree_items, tree_leaves, tree_map, tree_unflatten

__all__ = ["OptConfig", "init_opt_state", "opt_state_specs", "adamw_update",
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


def opt_state_specs(param_specs, cfg: OptConfig = OptConfig()):
    """Specs of the optimizer state (the reference's): the moments (and
    ``ef`` / ``master``) f32 with their parameter's shape and logical
    axes, ``step`` an int32 scalar."""
    from ..models.base import ParamSpec, map_specs

    def f32(ps):
        return ParamSpec(ps.shape, ps.axes, dtype=torch.float32)
    moments = map_specs(f32, param_specs)
    tree = {"mu": moments, "nu": moments,
            "step": ParamSpec((), (), dtype=torch.int32)}
    if cfg.compress_grads:
        tree["ef"] = moments
    if cfg.keep_master:
        tree["master"] = moments
    return tree


def _owned(shardings, mesh):
    """Per leaf (tree order) whether this rank counts it in the global
    norm: a leaf replicated over an axis is counted by the rank at
    index 0 of that axis only, so every element is counted once."""
    out = []
    for _, spec in tree_items(shardings):
        used = {a for e in spec for a in spec_axes(e)}
        out.append(all(mesh.coords[a] == 0 for a in mesh.axis_names
                       if a not in used))
    return out


def _clip_scale(grads, max_norm: float, shardings=None):
    """(the global L2 norm, the factor that scales it to at most
    ``max_norm``); the norm sums the leaves' squares in tree order, as
    the reference's Python ``sum`` does.  On a mesh (``shardings``, the
    leaves' ``logical_spec`` tuples) each rank sums the leaves it owns
    (``_owned``) and the sums are added over every rank."""
    mesh = current_mesh() if shardings is not None else None
    owned = None if mesh is None else _owned(shardings, mesh)
    gn = None
    for i, g in enumerate(tree_leaves(grads)):
        if owned is not None and not owned[i]:
            continue
        s = torch.sum(torch.square(g.float()))
        gn = s if gn is None else gn + s
    if gn is None:
        gn = torch.zeros((), dtype=torch.float32,
                         device=tree_leaves(grads)[0].device)
    if mesh is not None:
        gn = all_reduce(gn, mesh, mesh.axis_names)
    gn = torch.sqrt(gn)
    return gn, torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float, shardings=None):
    """(grads scaled to a global L2 norm of at most ``max_norm``, the
    norm before clipping); ``shardings`` as in ``_clip_scale``."""
    with torch.no_grad():
        gn, scale = _clip_scale(grads, max_norm, shardings)
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
                 compress_gen: Optional[torch.Generator] = None,
                 shardings=None):
    """One AdamW step.  Returns (params, state, metrics): new trees (the
    inputs are not modified), ``metrics`` with ``grad_norm`` and ``lr``.
    With ``cfg.compress_grads`` the gradients pass through int8 with
    error feedback first, each leaf's noise drawn from ``compress_gen``
    in tree order.  On a mesh the trees are this rank's shards and
    ``shardings`` their ``logical_spec`` tuples: the clip's norm is the
    whole gradient's (``_clip_scale``), the update each shard's."""
    with torch.no_grad():
        return _adamw(params, grads, state, cfg, compress_gen, shardings)


def _adamw(params, grads, state, cfg, compress_gen, shardings):
    step = state["step"]
    metrics: dict[str, Any] = {}
    mesh = current_mesh()
    if cfg.compress_grads and mesh is not None and mesh.size > 1:
        raise ValueError("compress_grads on a mesh of more than one rank "
                         "is not ported: its int8 scale is the whole "
                         "leaf's maximum")
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
    gnorm, scale = _clip_scale(grads, cfg.grad_clip, shardings)
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
