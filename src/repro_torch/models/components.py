"""Model primitives of the port: the subset of
``repro.models.components`` that the paged serving path runs (norms,
rotary, GQA attention with optional QKV bias, SwiGLU / GELU MLPs, the
single-device mixture of experts, tied or untied embeddings), with the
parameter specs of each part.

Plain functions of ``(params, inputs, cfg)`` on tensors.  The dtype
contract is the reference's: activations in the compute dtype (bf16),
weights stored f32 and cast to it at use, norms / RoPE / softmax / the
unembedding in f32, attention with bf16 operands and f32 accumulation.
Attention itself goes through the port's kernels
(``kernels/flash_attention``, ``kernels/paged_attention``); the
projections ``x @ W`` stay ``torch.matmul``, as the reference leaves
them to XLA.

Paged blocks write K/V into the page pool **in place** (the reference
returns updated pages functionally).  The fused step's write/read
disjointness (``repro.models.lm.fused_step_paged``) still holds: a
prefill row gathers its pages before any decode row of the same layer
writes, and the two groups' write targets are disjoint.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import flash_attention
from ..kernels.paged_attention import paged_attention
from .base import ParamSpec, normal, ones, zeros

__all__ = ["rms_norm", "layer_norm", "norm_specs", "apply_norm",
           "rope_freqs", "apply_rope", "attn_specs", "project_qkv",
           "out_proj", "mlp_specs", "mlp_block", "moe_specs",
           "moe_capacity", "moe_route", "moe_block", "embed_specs",
           "embed_tokens", "unembed", "decode_attention",
           "chunk_scatter_targets", "verify_scatter_targets",
           "paged_verify_attention_block",
           "paged_chunk_attention_block"]


# ---------------------------------------------------------------- norms
def rms_norm(x, scale, eps: float):
    """RMSNorm scaled by ``1 + scale`` (zero-initialized scale), in f32."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


def layer_norm(x, scale, bias, eps: float):
    """LayerNorm scaled by ``scale`` (one-initialized), plus ``bias``
    when given, in f32."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dt)


def norm_specs(d: int, kind: str) -> dict:
    if kind == "rmsnorm":
        return {"scale": ParamSpec((d,), init=zeros)}
    return {"scale": ParamSpec((d,), init=ones),
            "bias": ParamSpec((d,), init=zeros)}


def apply_norm(p, x, kind: str, eps: float):
    if kind == "rmsnorm":
        return rms_norm(x, p["scale"], eps)
    return layer_norm(x, p["scale"], p.get("bias"), eps)


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


# ------------------------------------------------------------ attention
def attn_specs(cfg) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    h, kvh = cfg.n_heads, cfg.n_kv_heads
    p = {"wq": ParamSpec((d, h * hd)), "wk": ParamSpec((d, kvh * hd)),
         "wv": ParamSpec((d, kvh * hd)), "wo": ParamSpec((h * hd, d))}
    if cfg.qkv_bias:
        p["bq"] = ParamSpec((h * hd,), init=zeros)
        p["bk"] = ParamSpec((kvh * hd,), init=zeros)
        p["bv"] = ParamSpec((kvh * hd,), init=zeros)
    if cfg.qk_norm:
        p["q_norm"] = ParamSpec((hd,), init=zeros)
        p["k_norm"] = ParamSpec((hd,), init=zeros)
    return p


def project_qkv(p, x, cfg, positions):
    """x: (B, S, D) -> q (B, S, H, Dh), k/v (B, S, KVH, Dh), QKV bias
    (added in the compute dtype after the product), qk-norm and RoPE
    applied.  ``p`` is one layer's attention parameters."""
    B, S, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = q.reshape(B, S, h, hd)
    k = k.reshape(B, S, kvh, hd)
    v = v.reshape(B, S, kvh, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.rope_kind == "rope":
        q = apply_rope(q, positions, theta=cfg.rope_theta,
                       fraction=cfg.rope_fraction)
        k = apply_rope(k, positions, theta=cfg.rope_theta,
                       fraction=cfg.rope_fraction)
    return q.contiguous(), k.contiguous(), v.contiguous()


def out_proj(p, out):
    """(B, S, H, Dh) attention output -> (B, S, D)."""
    B, S = out.shape[:2]
    out = out.reshape(B, S, -1)
    return out @ p["wo"].to(out.dtype)


def decode_attention(q, k_cache, v_cache, pos: int):
    """Single-token attention against a contiguous cache.

    q: (B, 1, H, Dh); caches: (B, S_max, KVH, Dh); ``pos``: tokens
    attendable (including the one just written).  The cache IS a page
    pool of B pages of S_max tokens under the identity table, so this
    runs the paged kernel: the contiguous oracle and the paged engine
    share one kernel and one summation order."""
    B = q.shape[0]
    tables = torch.arange(B, dtype=torch.int32, device=q.device)[:, None]
    lengths = torch.full((B,), pos - 1, dtype=torch.int32, device=q.device)
    return paged_attention(q, k_cache, v_cache, tables, lengths)


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
                                 v_pages, page_table, lengths):
    """Verification attention sub-layer (paged decode with a query-time
    axis).  x: (B, T, D), token t of row b at position
    ``lengths[b] + t``.  All T tokens' K/V are written into their page
    slots first (in place), then each query attends causally up to its
    own position.  T = 1 is the decode step (the reference's
    ``paged_attention_block``): one code path, so decode and verify at
    T = 1 agree by construction."""
    B, T, _ = x.shape
    q, k, v = project_qkv(p, x, cfg, positions)
    pid, slot = verify_scatter_targets(lengths, page_table, T,
                                       k_pages.shape[1])
    k_pages[pid, slot] = k.to(k_pages.dtype)
    v_pages[pid, slot] = v.to(v_pages.dtype)
    out = paged_attention(q, k_pages, v_pages, page_table, lengths)
    return out_proj(p, out)


def paged_chunk_attention_block(p, x, cfg, *, positions, starts, n_valid,
                                k_pages, v_pages, table_rows):
    """Batched chunked-prefill attention sub-layer over the page pool.

    x: (B, C, D), token t of row b at position ``starts[b] + t``;
    tokens t >= n_valid[b] are padding.  Each row's context is gathered
    from its table into a contiguous (nb * ps + C) buffer, the chunk's
    own K/V overlaid at the row's offset, and attention runs through
    the flash kernel with a per-row ``q_offset`` — the same anchored
    partition as whole-prompt prefill, so each row is bit-identical to
    it.  The chunk's K/V is then persisted into the pool in place
    (padding to the null page)."""
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
    return out_proj(p, out)


# ------------------------------------------------------------------ mlp
def mlp_specs(cfg) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_kind == "gelu":
        return {"w1": ParamSpec((d, f)), "b1": ParamSpec((f,), init=zeros),
                "w2": ParamSpec((f, d)), "b2": ParamSpec((d,), init=zeros)}
    return {"wg": ParamSpec((d, f)), "wu": ParamSpec((d, f)),
            "wd": ParamSpec((f, d))}


def mlp_block(p, x, cfg):
    """Dense FFN in the compute dtype: SwiGLU silu(x Wg) * (x Wu) Wd, or
    GELU (tanh approximation, ``jax.nn.gelu``'s default) with biases."""
    if cfg.mlp_kind == "gelu":
        h = x @ p["w1"].to(x.dtype) + p["b1"].to(x.dtype)
        h = F.gelu(h, approximate="tanh")
        return h @ p["w2"].to(x.dtype) + p["b2"].to(x.dtype)
    g = F.silu(x @ p["wg"].to(x.dtype))
    u = x @ p["wu"].to(x.dtype)
    return (g * u) @ p["wd"].to(x.dtype)


# ------------------------------------------------------------------ moe
def moe_specs(cfg) -> dict:
    m = cfg.moe
    d, fe, e = cfg.d_model, m.d_expert_ff, m.n_experts
    p = {"router": ParamSpec((d, e), init=normal(0.02)),
         "wg": ParamSpec((e, d, fe)), "wu": ParamSpec((e, d, fe)),
         "wd": ParamSpec((e, fe, d))}
    if m.n_shared:
        fs = fe * m.n_shared
        p["shared"] = {"wg": ParamSpec((d, fs)), "wu": ParamSpec((d, fs)),
                       "wd": ParamSpec((fs, d))}
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
    probs = torch.softmax(xf.float() @ p["router"].float(), dim=-1)
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = topw[:, :m.top_k], topi[:, :m.top_k]
    if m.normalize_router:
        topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    return probs, topw, topi


def moe_block(p, x, cfg):
    """Mixture of experts on one device (the reference's
    ``_moe_compute`` at ``ep_size = 1``).  x: (B, S, D) -> (y (B, S, D),
    the Switch load-balance aux loss).

    Every (token, choice) pair takes the next free slot of its expert in
    token order; pairs past an expert's capacity C are dropped: they are
    written to a spare slot C that no product reads, and read back from
    a zero row there.  The experts' SwiGLU runs as (E, C, D) batched
    products in the compute dtype; the gate-weighted outputs are added
    back per token, then the shared expert's dense SwiGLU."""
    m = cfg.moe
    B, S, D = x.shape
    T, E, K = B * S, m.n_experts, m.top_k
    C = moe_capacity(T, m)
    xf = x.reshape(T, D)
    probs, topw, topi = moe_route(p, xf, cfg)
    eid = topi.reshape(-1)                                   # (T*K,)
    gate = topw.reshape(-1)
    tok = torch.arange(T * K, device=x.device) // K
    onehot = F.one_hot(eid, E)
    pos = torch.cumsum(onehot, dim=0) - onehot
    pos = torch.gather(pos, 1, eid[:, None])[:, 0]
    pos = torch.where(pos < C, pos, C)                       # C: dropped
    x_e = x.new_zeros(E, C + 1, D)
    x_e[eid, pos] = xf[tok]
    x_e = x_e[:, :C]
    g = F.silu(torch.bmm(x_e, p["wg"].to(x.dtype)))
    u = torch.bmm(x_e, p["wu"].to(x.dtype))
    y_e = F.pad(torch.bmm(g * u, p["wd"].to(x.dtype)), (0, 0, 0, 1))
    y_tok = y_e[eid, pos]                                    # (T*K, D)
    y = x.new_zeros(T, D).index_add_(
        0, tok, y_tok * gate[:, None].to(x.dtype))
    if m.n_shared:
        sp = p["shared"]
        sg = F.silu(xf @ sp["wg"].to(x.dtype))
        su = xf @ sp["wu"].to(x.dtype)
        y = y + (sg * su) @ sp["wd"].to(x.dtype)
    me = probs.mean(dim=0)
    ce = F.one_hot(topi[:, 0], E).float().mean(dim=0)
    return y.reshape(B, S, D), E * torch.sum(me * ce)


# ----------------------------------------------------------- embeddings
def embed_specs(cfg) -> dict:
    p = {"tok": ParamSpec((cfg.vocab_size, cfg.d_model), init=normal(0.02))}
    if not cfg.tie_embeddings:
        p["head"] = ParamSpec((cfg.d_model, cfg.vocab_size))
    return p


def embed_tokens(p, tokens, cfg, dtype):
    return p["tok"][tokens.long()].to(dtype)


#: rows per unembedding product (see ``unembed``)
UNEMBED_ROWS = 64


def unembed(p, x, cfg):
    """Unembedding in f32: (..., D) -> (..., V), through the tied
    embedding table or the untied ``head``.

    The rows go through the f32 product in tiles of UNEMBED_ROWS, the
    last one zero-padded, so every product has the same shape.  A BLAS
    picks its kernel, and with it the summation order, by the number of
    rows (measured on the CPU: an f32 product gives a row other bits at
    1, 2 or up to 15 rows than at more), so a row's logits would
    otherwise depend on how many rows share the call, and the engine's
    logits would not match the oracle's bit for bit."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).float()
    M = x2.shape[0]
    pad = -M % UNEMBED_ROWS
    if pad:
        x2 = torch.cat([x2, x2.new_zeros(pad, x2.shape[1])])
    w = (p["tok"].t() if cfg.tie_embeddings else p["head"]).float()
    logits = torch.empty(M + pad, w.shape[1], dtype=torch.float32,
                         device=x.device)
    for i in range(0, M + pad, UNEMBED_ROWS):
        torch.matmul(x2[i:i + UNEMBED_ROWS], w,
                     out=logits[i:i + UNEMBED_ROWS])
    return logits[:M].reshape(*lead, -1)
