"""Dense-model primitives of the port (the subset of
``repro.models.components`` that qwen3-0.6b's serving path runs).

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

__all__ = ["rms_norm", "rope_freqs", "apply_rope", "project_qkv",
           "out_proj", "mlp_block", "embed_tokens", "unembed",
           "decode_attention",
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
def project_qkv(p, x, cfg, positions):
    """x: (B, S, D) -> q (B, S, H, Dh), k/v (B, S, KVH, Dh), qk-norm and
    RoPE applied.  ``p`` is one layer's attention parameters."""
    B, S, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"].to(x.dtype)).reshape(B, S, h, hd)
    k = (x @ p["wk"].to(x.dtype)).reshape(B, S, kvh, hd)
    v = (x @ p["wv"].to(x.dtype)).reshape(B, S, kvh, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
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
def mlp_block(p, x, cfg):
    """SwiGLU FFN: silu(x Wg) * (x Wu) Wd in the compute dtype."""
    g = F.silu(x @ p["wg"].to(x.dtype))
    u = x @ p["wu"].to(x.dtype)
    return (g * u) @ p["wd"].to(x.dtype)


# ----------------------------------------------------------- embeddings
def embed_tokens(p, tokens, cfg, dtype):
    return p["tok"][tokens.long()].to(dtype)


#: rows per unembedding product (see ``unembed``)
UNEMBED_ROWS = 64


def unembed(p, x, cfg):
    """Tied unembedding in f32: (..., D) -> (..., V).

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
    w = p["tok"].float().t()
    logits = torch.empty(M + pad, w.shape[1], dtype=torch.float32,
                         device=x.device)
    for i in range(0, M + pad, UNEMBED_ROWS):
        torch.matmul(x2[i:i + UNEMBED_ROWS], w,
                     out=logits[i:i + UNEMBED_ROWS])
    return logits[:M].reshape(*lead, -1)
