"""RWKV6 "Finch" blocks of the port (arXiv:2404.05892), the counterpart
of ``repro.models.rwkv6``: data-dependent decay WKV.

Time mixing is a linear recurrence over a matrix state per head

    S_t = diag(w_t) S_{t-1} + k_t v_t^T          (S: Dk x Dv)
    o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)

with per-channel, per-step decay w_t = exp(-exp(ww_t)) from a
token-shifted low-rank projection of the input; ww is clamped to <= 1.

A prompt has two forms.  ``wkv_scan`` (the default) runs the
recurrence step by step with the operations of a decode step
(``wkv_step``), so a decode step extends a prefill bit for bit.
``wkv_chunked`` is the reference's chunked-parallel form (chunks of 32:
an intra-chunk matrix plus an inter-chunk state scan), chosen with
``chunked=True``: the same sums in another order.  At rwkv6-3b's full
widths (``chip_smoke.py``'s families phase on an H100) the two agree to
2.4e-6 on the first layer's input and to 4.7e-5 in the logits of an f32
model, but 0.49 apart in bf16, where the bf16 model itself lies 0.67
from the f32 one: rounding to bf16 between the 32 layers grows the
difference, and a decode step after a chunked prefill lands 0.42 from
the whole forward, beyond the reference's 4e-2.  The recurrence is
plain PyTorch in f32, as in the reference (jnp, no Pallas kernel); the
projections go through ``components.linear``.

On a training mesh (``sharding/spmd.py``) the time mix splits by heads
(``tp.heads``): ``wr/wk/wv/wg`` column-parallel, ``wo`` row-parallel,
``u`` and the group norm's scale and bias this rank's heads, the WKV on
them.  Where ``model`` divides H a rank holds H / m heads in every
call, its WKV state too; where it does not, a call without a state
splits them unevenly (``spmd.rank_heads``: ``localize`` gathers those
leaves and cuts the rank's heads) and a call with a state, or a
prefill that builds one, runs every head on every rank, as the
reference's state specs replicate the head dim there.  The token mix
(``tm_w1`` / ``tm_w2``) and the decay LoRA's ``wd1`` are replicated over
``model``: every rank computes them whole, and what leaves that
duplicated work for the rank's heads (the four mixed inputs through
``components.fanout_linear``, the decay's input through
``components.head_columns_linear``) carries back the sum over
``model`` of the ranks' gradients, so the gradients of their weights
are alike on every rank: each rank forms its 1 / m of their columns
and all-gathers them (``components.replicated_linear``).  ``wd2`` and
``w0`` are cut to the channels of the rank's heads before the product
(``head_columns_linear``: its dX summed over ``model``, the dW columns
all-gathered, uneven where the heads are).  The
channel mix splits its hidden dim (``tp.ff``: ``wk`` column-, ``wv``
row-parallel); its gate ``sigmoid(xr @ wr)`` is duplicated and
multiplies the summed output, so the gradient of ``wr`` is alike on
every rank: each computes its columns of it and all-gathers them
(``components.replicated_linear``), as GSPMD splits that product.  The WKV state splits by heads; the token-shift
states stay whole.  Under sequence parallelism (``tp.seq``) both blocks
gather the sequence first (the token shift reads the position before,
which may be another rank's) and run as without it; the heads' and the
hidden dim's sums leave reduce-scattered along the sequence, the
channel mix's duplicated gate keeps the rank's rows.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import components as C
from .base import (ParamSpec, linspace_first_axis, normal, ones, uniform,
                   zeros)

__all__ = ["TM_LORA", "DECAY_LORA", "WW_CLAMP", "rwkv_time_specs",
           "rwkv_ffn_specs", "wkv_scan", "wkv_chunked", "wkv_step",
           "wkv_inputs", "rwkv_time_block",
           "rwkv_channel_block", "rwkv_state_specs"]

TM_LORA = 32     # token-mix ddlerp low-rank dim
DECAY_LORA = 64
WW_CLAMP = 1.0   # ww <= 1  ->  per-step log-decay >= -e
CHUNK = 32       # wkv_chunked's chunk length


def rwkv_time_specs(cfg) -> dict:
    d = cfg.d_model
    h, dh = cfg.n_heads, cfg.head_dim
    mu = {f"mu_{n}": ParamSpec((d,), ("stats",), init=uniform())
          for n in ("x", "w", "k", "v", "r", "g")}
    return {
        **mu,
        "tm_w1": ParamSpec((d, 5 * TM_LORA), ("embed", None),
                           init=normal(1e-3)),
        "tm_w2": ParamSpec((5, TM_LORA, d), (None, None, "embed"),
                           init=normal(1e-3)),
        "w0": ParamSpec((d,), ("stats",),
                        init=linspace_first_axis(-6.0, -0.5)),
        "wd1": ParamSpec((d, DECAY_LORA), ("embed", None), init=normal(1e-3),
                         f32=True),
        "wd2": ParamSpec((DECAY_LORA, d), (None, "embed"), init=normal(1e-3),
                         f32=True),
        "wr": ParamSpec((d, h * dh), ("embed", "q_heads")),
        "wk": ParamSpec((d, h * dh), ("embed", "q_heads")),
        "wv": ParamSpec((d, h * dh), ("embed", "q_heads")),
        "wg": ParamSpec((d, h * dh), ("embed", "q_heads")),
        "wo": ParamSpec((h * dh, d), ("q_heads", "embed")),
        "u": ParamSpec((h, dh), ("act_heads", None), init=normal(0.3)),
        "ln_x_scale": ParamSpec((h, dh), ("act_heads", None), init=ones),
        "ln_x_bias": ParamSpec((h, dh), ("act_heads", None), init=zeros),
    }


def rwkv_ffn_specs(cfg) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {"mu_k": ParamSpec((d,), ("stats",), init=uniform()),
            "mu_r": ParamSpec((d,), ("stats",), init=uniform()),
            "wk": ParamSpec((d, f), ("embed", "ff")),
            "wv": ParamSpec((f, d), ("ff", "embed")),
            "wr": ParamSpec((d, d), ("embed", None))}


def _shift(x, state):
    """Token shift: x_{t-1} (zeros, or the carried state, at t = 0)."""
    if state is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    if x.shape[1] != 1:
        raise ValueError("a carried token shift takes one token a row")
    return state[:, None].to(x.dtype)


def _ddlerp(p, x, xx, tp=None):
    """Data-dependent token-shift mix -> (xw, xk, xv, xr, xg); on a mesh
    each LoRA weight's gradient split over ``model``
    (``components.replicated_linear``)."""
    B, S, D = x.shape
    xxx = x + xx * p["mu_x"].to(x.dtype)
    z = torch.tanh(C.replicated_linear(xxx, p["tm_w1"], tp)).reshape(
        B, S, 5, TM_LORA)
    mus = ("mu_w", "mu_k", "mu_v", "mu_r", "mu_g")
    return tuple(
        x + xx * (p[mu].to(x.dtype)
                  + C.replicated_linear(z[:, :, i], p["tm_w2"][i], tp))
        for i, mu in enumerate(mus))


def _decay(p, xw, tp=None, head_dim=None):
    """Per-channel log-decay lw = -exp(ww) <= 0, ww clamped, in f32;
    with ``tp.heads`` the channels of this rank's heads only (``wd2``'s
    and ``w0``'s columns cut before the product,
    ``components.head_columns_linear``)."""
    h = torch.tanh(C.replicated_linear(xw.float(), p["wd1"], tp))
    if tp is not None and tp.heads:
        ww = C.head_columns_linear(h, p["wd2"], p["w0"].float(), tp,
                                   head_dim)
    else:
        ww = p["w0"].float() + C.linear(h, p["wd2"])
    return -torch.exp(torch.clamp(ww, max=WW_CLAMP))


def wkv_scan(r, k, v, lw, u):
    """The WKV recurrence over a prompt, one ``wkv_step`` a token from
    a zero state.  r, k, v, lw (log-decay <= 0): (B, S, H, Dh); u: (H,
    Dh).  Returns (o (B, S, H, Dh) f32, final state (B, H, Dk, Dv) f32)."""
    B, S, H, Dh = r.shape
    state = torch.zeros(B, H, Dh, Dh, dtype=torch.float32, device=r.device)
    o = torch.empty(B, S, H, Dh, dtype=torch.float32, device=r.device)
    for t in range(S):
        o[:, t:t + 1], state = wkv_step(r[:, t:t + 1], k[:, t:t + 1],
                                        v[:, t:t + 1], lw[:, t:t + 1], u,
                                        state)
    return o, state


def wkv_chunked(r, k, v, lw, u):
    """The reference's chunked-parallel WKV over a prompt, from a zero
    state: within a chunk of L (CHUNK, or the largest divisor of S below
    it) an (L, L) decay-weighted matrix, across chunks a scan of the
    state.  Arguments and results as ``wkv_scan``'s; all math f32."""
    B, S, H, Dh = r.shape
    L = min(CHUNK, S)
    while S % L:                   # non-multiple-of-32 prompt lengths
        L -= 1
    rc, kc, vc, wc = (a.float().reshape(B, S // L, L, H, Dh)
                      .permute(1, 0, 3, 2, 4)              # (n, B, H, L, Dh)
                      for a in (r, k, v, lw))
    below = torch.tril(torch.ones(L, L, dtype=torch.bool, device=r.device),
                       diagonal=-1)
    state = torch.zeros(B, H, Dh, Dh, dtype=torch.float32, device=r.device)
    outs = []
    for r_, k_, v_, w_ in zip(rc, kc, vc, wc):             # (B, H, L, Dh)
        cum = torch.cumsum(w_, dim=2) - w_                 # exclusive
        total = cum[:, :, -1:] + w_[:, :, -1:]             # (B, H, 1, Dh)
        q_adj = r_ * torch.exp(cum - total)
        k_adj = k_ * torch.exp(total - (cum + w_))
        a = torch.einsum("bhid,bhjd->bhij", q_adj, k_adj)
        a = torch.where(below, a, 0.0)
        diag = torch.einsum("bhid,bhid->bhi", r_, k_ * u[None, :, None])
        o = (torch.einsum("bhij,bhjd->bhid", a, v_) + diag[..., None] * v_
             + torch.einsum("bhid,bhde->bhie", r_ * torch.exp(cum), state))
        state = (state * torch.exp(total).transpose(2, 3)
                 + torch.einsum("bhjd,bhje->bhde", k_adj, v_))
        outs.append(o)
    o = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(B, S, H, Dh)
    return o, state


def wkv_step(r, k, v, lw, u, state):
    """One decode step.  r, k, v, lw: (B, 1, H, Dh); state (B, H, Dk,
    Dv) f32.  Returns (o (B, 1, H, Dh) f32, new state)."""
    r_, k_, v_, w_ = (a.float()[:, 0] for a in (r, k, v, lw))
    kv = k_[..., :, None] * v_[..., None, :]                   # (B,H,Dk,Dv)
    o = C.row_sum(r_[..., None] * (state + u[None, :, :, None] * kv),
                  -2)[..., 0, :]
    new = state * torch.exp(w_)[..., None] + kv
    return o[:, None], new


def wkv_inputs(p, x, cfg, state=None, tp=None):
    """(r, k, v, lw, u, g) of the time-mixing block for x (B, S, D):
    r, k, v, lw (B, S, H, Dh), u (H, Dh) f32, and the output gate g
    (B, S, H * Dh); with ``tp.heads`` H is this rank's heads
    (``tp.head_range``; see the module docstring).  ``state``: as
    ``rwkv_time_block``'s."""
    B, S, D = x.shape
    H, Dh = cfg.n_heads, cfg.head_dim
    xx = _shift(x, None if state is None else state["shift"]) - x
    xw, xk, xv, xr, xg = _ddlerp(p, x, xx, tp)
    lw = _decay(p, xw, tp, Dh)
    lin = C.linear
    if tp is not None and tp.heads:
        H = len(tp.head_range)

        def lin(x, w):
            return C.fanout_linear(x, w, tp=tp)[0]
    lw = lw.reshape(B, S, H, Dh)
    r = lin(xr, p["wr"]).reshape(B, S, H, Dh)
    k = lin(xk, p["wk"]).reshape(B, S, H, Dh)
    v = lin(xv, p["wv"]).reshape(B, S, H, Dh)
    g = F.silu(lin(xg, p["wg"]))
    return r, k, v, lw, p["u"].float(), g


def rwkv_time_block(p, x, cfg, *, state=None, chunked: bool = False,
                    tp=None):
    """Time-mixing block.  ``state`` (decode): {"shift": (B, D), "wkv":
    (B, H, Dh, Dh) f32}.  A prompt runs ``wkv_chunked`` if ``chunked``,
    else ``wkv_scan``.  Returns (out (B, S, D), state after the last
    token).  ``tp``: see the module docstring (H is then this rank's
    heads, in the WKV state too)."""
    if tp is not None and tp.seq and not tp.heads:
        return C.whole_sequence(lambda x, tp: rwkv_time_block(
            p, x, cfg, chunked=chunked, tp=tp), x, tp)
    outer = tp
    if tp is not None and tp.seq:
        # the token shift and the duplicated token mix and decay LoRA
        # need the whole sequence; the heads' sum leaves reduce-scattered
        x, tp = C.gather_sequence(x, tp)
    B, S, D = x.shape
    r, k, v, lw, u, g = wkv_inputs(p, x, cfg, state, tp)
    H, Dh = r.shape[2], r.shape[3]
    if state is None:
        o, wkv = (wkv_chunked if chunked else wkv_scan)(r, k, v, lw, u)
    else:
        o, wkv = wkv_step(r, k, v, lw, u, state["wkv"])
    o = C.group_norm_heads(o.reshape(B, S, H, Dh), p["ln_x_scale"],
                           p["ln_x_bias"], 64e-5).to(x.dtype)
    o = o.reshape(B, S, H * Dh) * g
    out = (C.row_parallel(o, p["wo"], outer) if tp is not None and tp.heads
           else C.linear(o, p["wo"]))
    return out, {"shift": x[:, -1], "wkv": wkv}


def rwkv_channel_block(p, x, cfg, *, state=None, tp=None):
    """Channel-mixing FFN with token shift and squared ReLU; with
    ``tp.ff`` its hidden dim split (see the module docstring)."""
    if tp is not None and tp.seq and not tp.ff:
        return C.whole_sequence(lambda x, tp: rwkv_channel_block(
            p, x, cfg, tp=tp), x, tp)
    outer = tp
    if tp is not None and tp.seq:
        x, tp = C.gather_sequence(x, tp)
    xx = _shift(x, None if state is None else state["shift"]) - x
    xk = x + xx * p["mu_k"].to(x.dtype)
    xr = x + xx * p["mu_r"].to(x.dtype)
    if tp is not None and tp.ff:
        kk = torch.square(F.relu(C.fanout_linear(xk, p["wk"], tp=tp)[0]))
        v = C.row_parallel(kk, p["wv"], outer)
    else:
        v = C.linear(torch.square(F.relu(C.linear(xk, p["wk"]))), p["wv"])
    # the duplicated gate keeps the rank's rows (backward an all-gather);
    # its weight gradient, alike on every rank, is split over model
    gate = C.model_rows(torch.sigmoid(C.replicated_linear(xr, p["wr"], tp)),
                        outer)
    return gate * v, {"shift": x[:, -1]}


def rwkv_state_specs(cfg, batch: int) -> dict:
    """A layer's decode state specs (the reference's
    ``rwkv_state_specs``: shapes, logical axes, dtypes)."""
    h, dh, d = cfg.n_heads, cfg.head_dim, cfg.d_model
    return {"att_shift": ParamSpec((batch, d), ("batch", None),
                                   dtype=torch.bfloat16),
            "ffn_shift": ParamSpec((batch, d), ("batch", None),
                                   dtype=torch.bfloat16),
            "wkv": ParamSpec((batch, h, dh, dh),
                             ("batch", "act_heads", None, None))}
