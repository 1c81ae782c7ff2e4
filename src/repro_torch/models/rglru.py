"""Griffin recurrent block of the port: causal conv1d + RG-LRU, the
counterpart of ``repro.models.rglru`` (arXiv:2402.19427).

The RG-LRU is a gated diagonal linear recurrence

    r_t = sigmoid(x_t Wr + br)          (recurrence gate)
    i_t = sigmoid(x_t Wi + bi)          (input gate)
    log a_t = -c * softplus(L) * r_t    (c = 8, L learned)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

computed in f32.  A prompt runs an associative scan (``rglru_scan``:
log2(S) doubling steps, the form of the reference's
``lax.associative_scan``), a decode step one step of the recurrence
(``rglru_step``): the same recurrence, its f32 products in another
order.  At recurrentgemma-2b's full widths the two agree to 1.2e-7 on
the first layer's input, and a decode step extends a prefill bit for
bit (``chip_smoke.py``'s families phase on an H100).  The recurrence is
plain PyTorch, as in the reference (jnp, no Pallas kernel); the
projections go through ``components.linear``.

On a training mesh with ``tp.lru`` (``sharding/spmd.py``) the block
computes on this rank's slice of the width W: ``w_gate`` / ``w_in``
column-parallel (``components.fanout_linear``), the conv and the
recurrence per channel on the slice (no communication; the decode
state is the slice too), ``w_out`` row-parallel, and the replicated
vectors ``conv_b``, ``br``, ``bi``, ``lam`` cut to the slice through
``fanout`` (their gradient the sum over ``model``).  The gates'
products take the split W as their input dim (``("ff", None)``): see
``_gates``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..sharding.collectives import scatter
from ..sharding.spmd import MODEL
from . import components as C
from .base import ParamSpec, normal, uniform, zeros

__all__ = ["C_FACTOR", "CONV_WIDTH", "rglru_block_specs", "rglru_scan",
           "rglru_step", "causal_conv1d", "rglru_block",
           "rglru_state_specs"]

C_FACTOR = 8.0
CONV_WIDTH = 4


def rglru_block_specs(cfg) -> dict:
    d, w = cfg.d_model, cfg.lru_width
    return {
        "w_gate": ParamSpec((d, w), ("embed", "ff")),
        "w_in": ParamSpec((d, w), ("embed", "ff")),
        "conv_w": ParamSpec((CONV_WIDTH, w), ("conv", "ff"),
                            init=normal(0.1)),
        "conv_b": ParamSpec((w,), ("stats",), init=zeros),
        "wr": ParamSpec((w, w), ("ff", None), f32=True),
        "br": ParamSpec((w,), ("stats",), init=zeros),
        "wi": ParamSpec((w, w), ("ff", None), f32=True),
        "bi": ParamSpec((w,), ("stats",), init=zeros),
        # Lambda so that a = sigmoid(L)^c spreads over (0.9, 0.999)
        "lam": ParamSpec((w,), ("stats",), init=uniform(0.38, 0.8)),
        "w_out": ParamSpec((w, d), ("ff", "embed")),
    }


def _gates(p, x, tp=None):
    """x: (..., W) f32 -> (log_a, gated_x), both f32.

    With ``tp.lru`` x is this rank's W / m channels and ``wr`` / ``wi``
    its W / m rows: each product is a partial sum over the whole output
    width, of which the rank needs only its W / m columns.  The two f32
    partials are reduce-scattered in one collective (``Scatter``:
    forward the sum, this rank's columns kept; backward an all-gather
    of the columns' gradients).  Gathering x over W instead would also
    gather both W x W weights by rows and cut their columns, which in a
    decode step moves 2 W^2 floats a layer against 2 B W here."""
    if tp is not None and tp.lru:
        r, i = scatter(torch.stack([C.linear(x, p["wr"]),
                                    C.linear(x, p["wi"])]),
                       tp.mesh, MODEL, -1).unbind(0)
        r = torch.sigmoid(r + p["br"].to(x.dtype))
        i = torch.sigmoid(i + p["bi"].to(x.dtype))
    else:
        r = torch.sigmoid(C.linear(x, p["wr"], p["br"]))
        i = torch.sigmoid(C.linear(x, p["wi"], p["bi"]))
    log_a = -C_FACTOR * F.softplus(p["lam"].float()) * r
    a2 = torch.exp(2.0 * log_a)
    gx = torch.sqrt(torch.clamp(1.0 - a2, min=1e-12)) * (i * x)
    return log_a, gx


def rglru_scan(p, x, tp=None):
    """x: (B, S, W) -> (h (B, S, W) in x's dtype, final h (B, W) f32):
    ``h_t = a_t h_{t-1} + gx_t`` from h = 0 as an associative scan, each
    doubling step combining every position's (a, b) with the one ``d``
    earlier, (a1, b1) then (a2, b2) -> (a1 a2, b1 a2 + b2)."""
    log_a, gx = _gates(p, x.float(), tp)
    a, h = torch.exp(log_a), gx
    d = 1
    while d < x.shape[1]:
        h = h + a * F.pad(h[:, :-d], (0, 0, d, 0))
        a = a * F.pad(a[:, :-d], (0, 0, d, 0), value=1.0)
        d *= 2
    return h.to(x.dtype), h[:, -1]


def rglru_step(p, x, h_prev, tp=None):
    """x: (B, 1, W); h_prev: (B, W) f32 -> (out (B, 1, W), h (B, W))."""
    log_a, gx = _gates(p, x[:, 0].float(), tp)
    h = torch.exp(log_a) * h_prev + gx
    return h[:, None].to(x.dtype), h


def _taps(frames, w, b):
    """sum_i frames[i] w[i] + b in f32, taps added in order (the same
    operations for a prompt and a decode step)."""
    wf = w.float()
    y = frames[0].float() * wf[0]
    for i in range(1, CONV_WIDTH):
        y = y + frames[i].float() * wf[i]
    return y + b.float()


def causal_conv1d(x, w, b, state=None):
    """Depthwise causal conv of width CONV_WIDTH, in f32.  x: (B, S, W).
    With ``state`` (B, CONV_WIDTH - 1, W) one decode step (S == 1):
    returns (y, new state); else (y, None)."""
    if state is not None:
        buf = torch.cat([state.to(x.dtype), x], dim=1)       # (B, 4, W)
        y = _taps([buf[:, i] for i in range(CONV_WIDTH)], w, b)
        return y[:, None].to(x.dtype), buf[:, 1:]
    S = x.shape[1]
    pad = F.pad(x, (0, 0, CONV_WIDTH - 1, 0))
    y = _taps([pad[:, i:i + S] for i in range(CONV_WIDTH)], w, b)
    return y.to(x.dtype), None


def rglru_block(p, x, cfg, *, state=None, tp=None):
    """The Griffin recurrent block.  x: (B, S, D); ``state`` (decode):
    {"conv": (B, 3, W), "h": (B, W) f32}.  Returns (out (B, S, D), the
    state after the last token).  ``tp``: see the module docstring (W is
    then this rank's slice, in the state too; with ``tp.seq`` x and the
    output are this rank's sequence shard, and the conv and the scan
    run on the whole sequence)."""
    if tp is not None and tp.seq and not tp.lru:
        return C.whole_sequence(lambda x, tp: rglru_block(p, x, cfg,
                                                          tp=tp), x, tp)
    split = tp is not None and tp.lru
    if split:
        w = p["w_in"].shape[1]
        p = {**p, **{k: C.rank_slice(p[k], tp, w)
                     for k in ("conv_b", "br", "bi", "lam")}}
        gate, u = C.fanout_linear(x, p["w_gate"], p["w_in"], tp=tp)
    else:
        gate, u = C.linear(x, p["w_gate"]), C.linear(x, p["w_in"])
    gate = F.gelu(gate, approximate="tanh")
    if state is None:
        conv = u[:, -(CONV_WIDTH - 1):]
        u, _ = causal_conv1d(u, p["conv_w"], p["conv_b"])
        h, h_last = rglru_scan(p, u, tp)
    else:
        u, conv = causal_conv1d(u, p["conv_w"], p["conv_b"],
                                state=state["conv"])
        h, h_last = rglru_step(p, u, state["h"], tp)
    out = (C.row_parallel(gate * h, p["w_out"], tp) if split
           else C.linear(gate * h, p["w_out"]))
    return out, {"conv": conv, "h": h_last}


def rglru_state_specs(cfg, batch: int) -> dict:
    """The decode state's specs (the reference's ``rglru_state_specs``:
    shapes, logical axes, dtypes)."""
    w = cfg.lru_width
    return {"conv": ParamSpec((batch, CONV_WIDTH - 1, w),
                              ("batch", None, "ff"), dtype=torch.bfloat16),
            "h": ParamSpec((batch, w), ("batch", "ff"))}
