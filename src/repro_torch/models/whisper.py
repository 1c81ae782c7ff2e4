"""Whisper-style encoder-decoder of the port (arXiv:2212.04356), the
counterpart of ``repro.models.whisper.WhisperModel``.

The conv/mel frontend is a stub, as in the reference: the batch carries
precomputed frame embeddings ``frames`` (B, n_frames, d_model).
Sinusoidal positions on the encoder and the decoder, bidirectional
encoder self-attention, causal decoder self-attention plus
cross-attention to the encoder output, pre-LayerNorm, GELU MLPs, tied
unembedding.  The encoder's and the cross-attention's attention run the
flash kernel without a causal mask, and so does a decode step's
self-attention at one query row (the encoder-decoder does not page),
which gives it the bits of the same row of a whole prefill.

``apply(..., train=True)`` is the training forward: with ``cfg.remat ==
"full"`` each encoder and each decoder block under
``torch.utils.checkpoint`` (the reference checkpoints the decoder's;
rematerialising the encoder's too changes the memory, not a value), and
where grad is enabled the attention (the cross-attention's Sq queries
against the frames included) runs the flash kernel's backward.

Caches are updated **in place** (the reference returns new arrays).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..launch.mesh import current_mesh
from ..sharding import spmd
from . import components as C
from .base import ParamSpec, init_params, with_param_dtype
from .meshed import MeshModel

__all__ = ["WhisperModel", "param_specs"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _enc_layer(cfg) -> dict:
    n = C.norm_specs(cfg.d_model, cfg.norm_kind)
    return {"ln1": n, "attn": C.attn_specs(cfg), "ln2": n,
            "mlp": C.mlp_specs(cfg)}


def _dec_layer(cfg) -> dict:
    n = C.norm_specs(cfg.d_model, cfg.norm_kind)
    return {"ln1": n, "self_attn": C.attn_specs(cfg), "ln_x": n,
            "cross_attn": C.attn_specs(cfg), "ln2": n,
            "mlp": C.mlp_specs(cfg)}


def param_specs(cfg) -> dict:
    """The reference's parameter tree: ``enc_NN`` and ``dec_NN`` layers,
    unstacked, stored in ``cfg.param_dtype`` (``with_param_dtype``)."""
    d = cfg.d_model
    specs = {"embed": C.embed_specs(cfg),
             "enc_final_norm": C.norm_specs(d, cfg.norm_kind),
             "final_norm": C.norm_specs(d, cfg.norm_kind)}
    for i in range(cfg.n_encoder_layers):
        specs[f"enc_{i:02d}"] = _enc_layer(cfg)
    for i in range(cfg.n_layers):
        specs[f"dec_{i:02d}"] = _dec_layer(cfg)
    return with_param_dtype(specs, cfg.param_dtype)


class WhisperModel(MeshModel):
    def __init__(self, cfg, device=None):
        if not cfg.is_encoder_decoder:
            raise ValueError(f"{cfg.name} is not an encoder-decoder")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = _DTYPES[cfg.compute_dtype]

    def param_specs(self) -> dict:
        return param_specs(self.cfg)

    def init(self, seed: int = 0, cast=None) -> dict:
        return init_params(self.param_specs(), seed, self.device, cast)

    def supports_paged_decode(self) -> bool:
        return False

    def _norm(self, p, x):
        return C.apply_norm(p, x, self.cfg.norm_kind, self.cfg.norm_eps)

    def _remat(self, train: bool, fn, *args):
        """``fn(*args)``, under ``torch.utils.checkpoint`` in the
        training forward with ``cfg.remat == "full"``."""
        if train and self.cfg.remat == "full":
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    # ----------------------------------------------------------- encoder
    def _local(self, name, p):
        """A layer's stored shards as its computation reads them: on a
        mesh (FSDP over ``data``; a model axis is refused) each
        data-sharded leaf gathered (``sharding.spmd.localize``)."""
        mesh = current_mesh()
        if mesh is None:
            return p
        return spmd.localize(p, self.placement(mesh)[name], spmd.TP(mesh))

    def _enc_block(self, name, p, x, pos):
        p = self._local(name, p)
        a, _ = C.attention_block(p["attn"], self._norm(p["ln1"], x),
                                 self.cfg, positions=pos, causal=False,
                                 paged=False)
        x = x + a
        return x + C.mlp_block(p["mlp"], self._norm(p["ln2"], x), self.cfg)

    def encode(self, params, frames, train: bool = False):
        """frames (B, F, D) stub embeddings -> encoder states (B, F, D)."""
        cfg = self.cfg
        frames = frames.to(self.device)
        B, F, D = frames.shape
        x = (frames.to(self.dtype)
             + C.sinusoid_pos(F, D, self.device).to(self.dtype)[None])
        pos = torch.arange(F, device=self.device)[None].expand(B, F)
        for i in range(cfg.n_encoder_layers):
            name = f"enc_{i:02d}"
            x = self._remat(train, lambda p, x, n=name: self._enc_block(
                n, p, x, pos), params[name], x)
        return self._norm(params["enc_final_norm"], x)

    def cross_kv(self, params, enc_out) -> dict:
        names = [f"dec_{i:02d}" for i in range(self.cfg.n_layers)]
        return {n: C.encode_cross_kv(self._local(n, params[n])["cross_attn"],
                                     enc_out, self.cfg) for n in names}

    # ----------------------------------------------------------- decoder
    def _dec_block(self, name, p, x, positions, cross, cache=None,
                   cache_pos=None):
        cfg = self.cfg
        p = self._local(name, p)
        a, kv = C.attention_block(
            p["self_attn"], self._norm(p["ln1"], x), cfg,
            positions=positions, cache=cache, cache_pos=cache_pos,
            paged=False)
        x = x + a
        x = x + C.cross_attention_block(
            p["cross_attn"], self._norm(p["ln_x"], x), cross, cfg)
        return x + C.mlp_block(p["mlp"], self._norm(p["ln2"], x), cfg), kv

    def _decoder(self, params, x, positions, cross, *, caches=None,
                 cache_pos=None, train: bool = False):
        kvs = {}
        for i in range(self.cfg.n_layers):
            name = f"dec_{i:02d}"
            if train:
                x = self._remat(
                    True, lambda p, x, k, v, n=name: self._dec_block(
                        n, p, x, positions, (k, v))[0],
                    params[name], x, *cross[name])
                continue
            x, kvs[name] = self._dec_block(
                name, params[name], x, positions, cross[name],
                None if caches is None else caches[name], cache_pos)
        return x, kvs

    def _embed_at(self, params, tokens, pe):
        """Token embeddings plus sinusoidal positions ``pe`` (S, D)."""
        return self._embed(params, tokens) + pe.to(self.dtype)[None]

    def apply(self, params, batch, *, train: bool = False,
              want_hidden: bool = False, want_aux: bool = False):
        """Whole forward: batch = {"frames", "tokens"} -> decoder logits
        (B, S, V) f32, or with ``want_hidden`` the final-norm hidden
        states (B, S, D); with ``want_aux`` also ``{"moe_aux": 0}`` (the
        reference's).  ``train``: the training forward (see the module
        docstring)."""
        x, _, _ = self._forward(params, batch, train)
        out = x if want_hidden else self.logits(params, x)
        if want_aux:
            return out, {"moe_aux": torch.zeros((), dtype=torch.float32,
                                                device=self.device)}
        return out

    def _forward(self, params, batch, train: bool = False):
        enc_out = self.encode(params, batch["frames"], train)
        cross = self.cross_kv(params, enc_out)
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        B, S = tokens.shape
        pos = torch.arange(S, device=self.device)[None].expand(B, S)
        x = self._embed_at(params, tokens,
                           C.sinusoid_pos(S, self.cfg.d_model, self.device))
        x, kvs = self._decoder(params, x, pos, cross, train=train)
        return self._norm(params["final_norm"], x), kvs, cross

    # ----------------------------------------------------------- serving
    def cache_specs(self, batch: int, seq_len: int) -> dict:
        """Specs of a cache (the reference's): self-attention K/V of
        capacity ``seq_len`` and cross K/V of ``n_frames``, bf16 on
        ``("batch", "kv_seq", "act_heads", None)``."""
        cfg = self.cfg

        def kv(s):
            return ParamSpec((batch, s, cfg.n_kv_heads, cfg.head_dim),
                             ("batch", "kv_seq", "act_heads", None),
                             dtype=torch.bfloat16)
        names = [f"dec_{i:02d}" for i in range(cfg.n_layers)]
        return {"self": {n: {"k": kv(seq_len), "v": kv(seq_len)}
                         for n in names},
                "cross": {n: (kv(cfg.n_frames), kv(cfg.n_frames))
                          for n in names},
                "pos": ParamSpec((), (), dtype=torch.int32)}

    def init_cache(self, batch: int, seq_len: int) -> dict:
        """An empty cache: zeros of ``cache_specs``, ``pos`` 0."""
        def zeros(ps):
            return torch.zeros(ps.shape, dtype=ps.dtype, device=self.device)
        specs = self.cache_specs(batch, seq_len)
        return {"self": {n: {k: zeros(ps) for k, ps in kv.items()}
                         for n, kv in specs["self"].items()},
                "cross": {n: tuple(map(zeros, kv))
                          for n, kv in specs["cross"].items()},
                "pos": 0}

    def prefill(self, params, batch, *, max_len: Optional[int] = None):
        """Encode + decoder prefill.  Returns (last-token logits (B, V),
        cache); ``max_len`` > S pads the self-attention caches."""
        x, kvs, cross = self._forward(params, batch)
        S = x.shape[1]
        if max_len is not None and max_len > S:
            for kv in kvs.values():
                for n in ("k", "v"):
                    c = kv[n]
                    kv[n] = torch.cat([c, c.new_zeros(
                        (c.shape[0], max_len - S) + c.shape[2:])], 1)
        last = self.logits(params, x[:, -1:])[:, 0]
        return last, {"self": kvs, "cross": cross, "pos": S}

    def decode_step(self, params, cache, tokens):
        """One decoder token against the self- and cross-attention
        caches; writes its K/V in place.  Returns (logits (B, V), cache)
        with ``pos`` advanced."""
        pos = int(cache["pos"])
        tokens = torch.as_tensor(tokens, device=self.device)
        B = tokens.shape[0]
        x = self._embed_at(params, tokens, C.sinusoid_pos_at(
            torch.tensor([pos], device=self.device), self.cfg.d_model))
        positions = torch.full((B, 1), pos, dtype=torch.long,
                               device=self.device)
        x, _ = self._decoder(params, x, positions, cache["cross"],
                             caches=cache["self"], cache_pos=pos)
        x = self._norm(params["final_norm"], x)
        cache["pos"] = pos + 1
        return self.logits(params, x)[:, 0], cache
