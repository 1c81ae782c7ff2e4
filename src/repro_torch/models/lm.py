"""Decoder-only LM of the port: the dense GQA family (qwen3) that the
serving path runs — the counterpart of ``repro.models.lm.DecoderLM``.

Parameters are a nested dict of tensors laid out exactly like the
reference's tree, with every layer's weights stacked on a leading L
axis (the reference's ``lax.scan`` layout), so the weight bridge
(``checkpoint/bridge.py``) is a key-for-key copy.  A Python loop over
layers takes the place of ``lax.scan``; each layer reads views of the
stacked tensors.

Entry points:

* ``apply``         logits over a whole sequence (whole-prompt prefill).
* ``prefill``       last-token logits + a contiguous decode cache.
* ``init_cache``    an empty contiguous cache (the draft model's).
* ``decode_step``   one token against the contiguous cache.
* ``prefill_chunk_paged`` / ``decode_step_paged`` / ``verify_step_paged``
  / ``fused_step_paged``  the serve engine's programs over the paged
  KV pool (``serve/kv_cache.py``).

Caches and page pools are updated **in place** (the reference returns
new arrays); each program returns the state it was given.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..device import resolve_device
from . import components as C
from .base import ParamSpec, init_params, normal, zeros

__all__ = ["DecoderLM", "param_specs"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _check_supported(cfg) -> None:
    """The port runs the dense GQA family of the serving path; anything
    else raises instead of computing something else."""
    unported = {
        "family": cfg.family != "dense",
        "block_pattern": set(cfg.layer_kinds) != {"attn"},
        "moe": cfg.moe is not None,
        "norm_kind": cfg.norm_kind != "rmsnorm",
        "mlp_kind": cfg.mlp_kind != "swiglu",
        "rope_kind": cfg.rope_kind != "rope",
        "qkv_bias": cfg.qkv_bias,
        "scale_embeddings": cfg.scale_embeddings,
        "logit_softcap": bool(cfg.logit_softcap),
        "untied embeddings": not cfg.tie_embeddings,
    }
    missing = [k for k, bad in unported.items() if bad]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: not ported yet ({', '.join(missing)})")


def param_specs(cfg) -> dict:
    """The reference's parameter tree for a scanned dense stack, f32
    storage (``param_dtype="float32"``)."""
    L, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    mix = {"wq": ParamSpec((L, d, h * hd)), "wk": ParamSpec((L, d, kvh * hd)),
           "wv": ParamSpec((L, d, kvh * hd)), "wo": ParamSpec((L, h * hd, d))}
    if cfg.qk_norm:
        mix["q_norm"] = ParamSpec((L, hd), init=zeros)
        mix["k_norm"] = ParamSpec((L, hd), init=zeros)
    return {
        "embed": {"tok": ParamSpec((cfg.vocab_size, d), init=normal(0.02))},
        "final_norm": {"scale": ParamSpec((d,), init=zeros)},
        "layers": {
            "ln1": {"scale": ParamSpec((L, d), init=zeros)},
            "mix": mix,
            "ln2": {"scale": ParamSpec((L, d), init=zeros)},
            "ffn": {"wg": ParamSpec((L, d, f)), "wu": ParamSpec((L, d, f)),
                    "wd": ParamSpec((L, f, d))},
        },
    }


def _layer(tree, i: int):
    """Layer ``i``'s view of a layer-stacked parameter tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


class DecoderLM:
    def __init__(self, cfg, device=None):
        _check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = _DTYPES[cfg.compute_dtype]

    # ------------------------------------------------------------ params
    def param_specs(self) -> dict:
        return param_specs(self.cfg)

    def init(self, seed: int = 0) -> dict:
        """Seeded random parameters on the model's device (the
        reference's distributions, not its bits)."""
        return init_params(self.param_specs(), seed, self.device)

    def supports_paged_decode(self) -> bool:
        return True

    # ------------------------------------------------------------ blocks
    def _norm(self, p, x):
        return C.rms_norm(x, p["scale"], self.cfg.norm_eps)

    def _ffn(self, lp, x):
        return x + C.mlp_block(lp["ffn"], self._norm(lp["ln2"], x), self.cfg)

    def _embed(self, params, tokens):
        return C.embed_tokens(params["embed"], tokens.to(self.device),
                              self.cfg, self.dtype)

    def _logits(self, params, x):
        x = self._norm(params["final_norm"], x)
        return C.unembed(params["embed"], x, self.cfg)

    # ------------------------------------------------- contiguous path
    def apply(self, params, tokens, *, want_cache: bool = False):
        """Whole-sequence forward.  tokens: (B, S) -> logits (B, S, V)
        f32; with ``want_cache`` also the per-layer K/V as a decode
        cache ``{"k", "v": (L, B, S, KVH, Dh), "pos": S}``."""
        cfg = self.cfg
        tokens = tokens.to(self.device)
        B, S = tokens.shape
        positions = torch.arange(S, device=self.device)[None].expand(B, S)
        x = self._embed(params, tokens)
        ks, vs = [], []
        for i in range(cfg.n_layers):
            lp = _layer(params["layers"], i)
            h = self._norm(lp["ln1"], x)
            q, k, v = C.project_qkv(lp["mix"], h, cfg, positions)
            out = C.flash_attention(q, k, v, q_offset=0, causal=True)
            x = x + C.out_proj(lp["mix"], out)
            x = self._ffn(lp, x)
            if want_cache:
                ks.append(k)
                vs.append(v)
        logits = self._logits(params, x)
        if want_cache:
            return logits, {"k": torch.stack(ks), "v": torch.stack(vs),
                            "pos": S}
        return logits

    def prefill(self, params, tokens, *, max_len: Optional[int] = None):
        """Forward + contiguous decode cache.  Returns (last-token
        logits (B, V), cache); ``max_len`` > S pads the cache with
        decode headroom."""
        logits, cache = self.apply(params, tokens, want_cache=True)
        S = tokens.shape[1]
        if max_len is not None and max_len > S:
            pad = max_len - S
            for n in ("k", "v"):
                c = cache[n]
                cache[n] = torch.cat(
                    [c, c.new_zeros(c.shape[:2] + (pad,) + c.shape[3:])], 2)
        return logits[:, -1], cache

    def init_cache(self, batch: int, seq_len: int) -> dict:
        """An empty contiguous decode cache of capacity ``seq_len``:
        ``{"k", "v": (L, batch, seq_len, KVH, Dh) bf16, "pos": 0}`` (the
        reference's cache layout and dtype)."""
        cfg = self.cfg
        shape = (cfg.n_layers, batch, seq_len, cfg.n_kv_heads, cfg.head_dim)
        def zeros():
            return torch.zeros(shape, dtype=torch.bfloat16,
                               device=self.device)
        return {"k": zeros(), "v": zeros(), "pos": 0}

    def decode_step(self, params, cache, tokens):
        """One lockstep decode step: tokens (B, 1) at position
        ``cache["pos"]``.  Writes this token's K/V into the cache in
        place; returns (logits (B, V), cache) with ``pos`` advanced."""
        cfg = self.cfg
        pos = int(cache["pos"])
        tokens = tokens.to(self.device)
        B = tokens.shape[0]
        positions = torch.full((B, 1), pos, dtype=torch.long,
                               device=self.device)
        x = self._embed(params, tokens)
        for i in range(cfg.n_layers):
            lp = _layer(params["layers"], i)
            h = self._norm(lp["ln1"], x)
            q, k, v = C.project_qkv(lp["mix"], h, cfg, positions)
            kc, vc = cache["k"][i], cache["v"][i]
            kc[:, pos] = k[:, 0].to(kc.dtype)
            vc[:, pos] = v[:, 0].to(vc.dtype)
            out = C.decode_attention(q, kc, vc, pos + 1)
            x = x + C.out_proj(lp["mix"], out)
            x = self._ffn(lp, x)
        cache["pos"] = pos + 1
        return self._logits(params, x)[:, 0], cache

    # ------------------------------------------------------ paged path
    def _verify_rows(self, params, xd, i, d_positions, state):
        """Layer ``i`` of the decode/verify rows (T >= 1 tokens each)."""
        lp = _layer(params["layers"], i)
        h = self._norm(lp["ln1"], xd)
        xd = xd + C.paged_verify_attention_block(
            lp["mix"], h, self.cfg, positions=d_positions,
            k_pages=state["k_pages"][i], v_pages=state["v_pages"][i],
            page_table=state["page_tables"], lengths=state["lengths"])
        return self._ffn(lp, xd)

    def _chunk_rows(self, params, xp, i, p_positions, state, table_rows,
                    starts, n_valid):
        """Layer ``i`` of the chunked-prefill rows."""
        lp = _layer(params["layers"], i)
        h = self._norm(lp["ln1"], xp)
        xp = xp + C.paged_chunk_attention_block(
            lp["mix"], h, self.cfg, positions=p_positions, starts=starts,
            n_valid=n_valid, k_pages=state["k_pages"][i],
            v_pages=state["v_pages"][i], table_rows=table_rows)
        return self._ffn(lp, xp)

    def _last_logits(self, params, xp, n_valid):
        """Logits of each row's last valid token: (B, V)."""
        idx = torch.clamp(n_valid.long() - 1, min=0)
        last = xp[torch.arange(xp.shape[0], device=xp.device), idx]
        return self._logits(params, last[:, None])[:, 0]

    def _paged_inputs(self, tokens, base):
        tokens = tokens.to(self.device)
        T = tokens.shape[1]
        positions = base.long()[:, None] + torch.arange(
            T, device=self.device)[None]
        return tokens, positions

    def prefill_chunk_paged(self, params, state, tokens, table_rows,
                            starts, n_valid):
        """Ingest one prompt chunk each for up to B requests (batched
        chunked prefill).  tokens (B, C): row b's token t sits at
        position ``starts[b] + t``; tokens t >= ``n_valid[b]`` are
        padding (written to the null page).  ``table_rows`` (B, nb):
        each row's page table cut to the dispatch's context bucket.
        Returns (last-valid-token logits (B, V), state)."""
        tokens, positions = self._paged_inputs(tokens, starts)
        x = self._embed(params, tokens)
        for i in range(self.cfg.n_layers):
            x = self._chunk_rows(params, x, i, positions, state, table_rows,
                                 starts, n_valid)
        return self._last_logits(params, x, n_valid), state

    def verify_step_paged(self, params, state, tokens):
        """Score T tokens per request against the paged cache: token t
        of row b sits at position ``lengths[b] + t`` and its K/V is
        written before attention.  T = 1 is the decode step.  Returns
        (logits (B, T, V), state) with ``lengths`` unchanged (the host
        owns them)."""
        tokens, positions = self._paged_inputs(tokens,
                                               state["lengths"])
        x = self._embed(params, tokens)
        for i in range(self.cfg.n_layers):
            x = self._verify_rows(params, x, i, positions, state)
        return self._logits(params, x), state

    def decode_step_paged(self, params, state, tokens):
        """One continuous-batching decode step, tokens (B, 1): the
        verify step at T = 1, so the two agree by construction.
        Returns (logits (B, V), state)."""
        if tokens.shape[1] != 1:
            raise ValueError("decode_step_paged takes one token per row")
        logits, state = self.verify_step_paged(params, state, tokens)
        return logits[:, 0], state

    def fused_step_paged(self, params, state, d_tokens, p_tokens,
                         p_table_rows, p_starts, p_n_valid):
        """Decode/verify every DECODING row AND ingest one chunk for
        every PREFILLING row in one program.  Each layer runs the
        prefill rows first, then the decode rows, on the in-place page
        pool: prefill gathers its own table prefix (which never holds a
        decode write target) before decode writes, and the two groups
        write disjoint (page, slot) targets, so each row is bit-identical
        to its unfused counterpart (``repro.models.lm.fused_step_paged``
        gives the disjointness argument).  Returns ((d_logits (B, T, V),
        p_logits (Bp, V)), state)."""
        d_tokens, d_positions = self._paged_inputs(d_tokens,
                                                   state["lengths"])
        p_tokens, p_positions = self._paged_inputs(p_tokens,
                                                   p_starts)
        xd = self._embed(params, d_tokens)
        xp = self._embed(params, p_tokens)
        for i in range(self.cfg.n_layers):
            xp = self._chunk_rows(params, xp, i, p_positions, state,
                                  p_table_rows, p_starts, p_n_valid)
            xd = self._verify_rows(params, xd, i, d_positions, state)
        return ((self._logits(params, xd),
                 self._last_logits(params, xp, p_n_valid)), state)
