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

Under ``with mesh:`` (``launch/mesh.py``) each block computes as
``sharding/spmd.py`` describes: FSDP gathers over ``data``, and over
``model`` the heads of the encoder's, the decoder's and the cross
attention (the cross K/V column-parallel from the encoder output, on
the KV heads the rank's query heads read,
``components.encode_cross_kv``; where ``model`` does not divide H each
rank its own run of whole heads, ``spmd.rank_heads``) and the GELU
MLP's hidden dim where it divides d_ff.  A prefill on a mesh keeps the
decoder's heads whole (its caches hold every head) and cuts the self
and cross caches along their sequence (``cache_specs``: ``kv_seq`` over
``model``), as ``shard_cache`` cuts a whole cache; a decode step
attends each shard and combines the partials.  Under ``SP_RULES`` the
encoder's and the decoder's streams each lie on sequence shards where
``model`` divides their length (``sharding/spmd.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..device import resolve_device
from ..launch.mesh import current_mesh
from ..sharding import spmd
from ..sharding.rules import tree_shardings
from . import components as C
from .base import ParamSpec, init_params, with_param_dtype
from .meshed import KV_AXES, MeshModel

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
            return C.remat(fn, *args)
        return fn(*args)

    # ----------------------------------------------------------- encoder
    def _local(self, name, p, *, whole_heads: bool = False,
               step: bool = False, seq_shards: int = 1, seq: bool = False):
        """(a layer's stored shards as its computation reads them, its
        split over ``model``): off a mesh (p, None); on one each
        data-sharded leaf gathered and the heads and the MLP's hidden
        dim split as placed (``sharding.spmd``).  ``whole_heads``: a
        prefill that builds caches; ``step``: a decode step, whose
        caches hold every head, its self cache split along its sequence
        over ``seq_shards`` ranks; ``seq``: the stream the layer reads
        lives on sequence shards (sequence parallelism).  ``p`` may hold
        only some of the layer's leaves."""
        mesh = current_mesh()
        if mesh is None:
            return p, None
        pl = self.placement(mesh)[name]
        tp = spmd.TP(mesh)
        if mesh.axis_size(spmd.MODEL) > 1:
            heads = self._heads_split(
                mesh, pl["attn" if "attn" in pl else "self_attn"],
                whole_heads, step)
            tp = spmd.TP(mesh, **heads,
                         ff=spmd.splits(pl["mlp"]["w1"][0], 1),
                         seq_shards=seq_shards, seq=seq)
        p = spmd.localize(p, pl, tp)
        # under sequence parallelism the norms run on the rank's rows
        return {k: C.fanout_tree(v, tp) if k.startswith("ln") else v
                for k, v in p.items()}, tp

    def _enc_block(self, name, p, x, pos, seq: bool = False):
        p, tp = self._local(name, p, seq=seq)
        a, _ = C.attention_block(p["attn"], self._norm(p["ln1"], x),
                                 self.cfg, positions=pos, causal=False,
                                 paged=False, tp=tp)
        x = x + a
        return x + C.mlp_block(p["mlp"], self._norm(p["ln2"], x), self.cfg,
                               tp=tp)

    def encode(self, params, frames, train: bool = False,
               seq: bool = False):
        """frames (B, F, D) stub embeddings -> encoder states (B, F, D);
        ``seq`` (sequence parallelism): the rank's rows of them, (B, F /
        m, D)."""
        cfg = self.cfg
        frames = frames.to(self.device)
        B, F, D = frames.shape
        x = (frames.to(self.dtype)
             + C.sinusoid_pos(F, D, self.device).to(self.dtype)[None])
        if seq:
            x = _rows(x, current_mesh())
        pos = torch.arange(F, device=self.device)[None].expand(B, F)
        for i in range(cfg.n_encoder_layers):
            name = f"enc_{i:02d}"
            x = self._remat(train, lambda p, x, n=name: self._enc_block(
                n, p, x, pos, seq), params[name], x)
        norm = params["enc_final_norm"]
        if seq:
            norm = C.fanout_tree(norm, spmd.TP(current_mesh(), seq=True))
        return self._norm(norm, x)

    def cross_kv(self, params, enc_out, whole_heads: bool = False,
                 seq: bool = False) -> dict:
        """Each decoder layer's cross K/V of the encoder output; on a
        mesh this rank's heads, or every head with ``whole_heads``;
        ``seq``: ``enc_out`` is the rank's rows of the frames, and the
        K/V hold every frame."""
        out = {}
        for i in range(self.cfg.n_layers):
            n = f"dec_{i:02d}"
            kv = {k: params[n]["cross_attn"][k] for k in ("wk", "wv")}
            p, tp = self._local(n, {"cross_attn": kv},
                                whole_heads=whole_heads, seq=seq)
            out[n] = C.encode_cross_kv(p["cross_attn"], enc_out, self.cfg,
                                       tp)
        return out

    # ----------------------------------------------------------- decoder
    def _dec_block(self, name, p, x, positions, cross, cache=None,
                   cache_pos=None, whole_heads: bool = False,
                   seq_shards=(1, 1), seq: bool = False):
        """One decoder layer: a prompt (``cache`` None) or one decode
        step; ``seq_shards``: how many ranks of ``model`` split the
        (self, cross) caches' sequence; ``seq``: x is the rank's
        sequence shard (sequence parallelism)."""
        cfg = self.cfg
        step = cache is not None
        # the cross K/V projections ran once a prompt (cross_kv)
        p = {**p, "cross_attn": {k: t for k, t in p["cross_attn"].items()
                                 if k not in ("wk", "wv")}}
        p, tp = self._local(name, p, whole_heads=whole_heads, step=step,
                            seq_shards=seq_shards[0], seq=seq)
        a, kv = C.attention_block(
            p["self_attn"], self._norm(p["ln1"], x), cfg,
            positions=positions, cache=cache, cache_pos=cache_pos,
            paged=False, tp=tp)
        x = x + a
        ctp = (None if tp is None
               else dataclasses.replace(tp, seq_shards=seq_shards[1]))
        x = x + C.cross_attention_block(
            p["cross_attn"], self._norm(p["ln_x"], x), cross, cfg, tp=ctp,
            step=step)
        return x + C.mlp_block(p["mlp"], self._norm(p["ln2"], x), cfg,
                               tp=tp), kv

    def _decoder(self, params, x, positions, cross, *, caches=None,
                 cache_pos=None, train: bool = False,
                 whole_heads: bool = False, seq_shards=(1, 1),
                 seq: bool = False):
        kvs = {}
        for i in range(self.cfg.n_layers):
            name = f"dec_{i:02d}"
            if train:
                x = self._remat(
                    True, lambda p, x, k, v, n=name: self._dec_block(
                        n, p, x, positions, (k, v), seq=seq)[0],
                    params[name], x, *cross[name])
                continue
            x, kvs[name] = self._dec_block(
                name, params[name], x, positions, cross[name],
                None if caches is None else caches[name], cache_pos,
                whole_heads, seq_shards, seq)
        return x, kvs

    def _embed_at(self, params, tokens, pe, seq: bool = False):
        """Token embeddings plus sinusoidal positions ``pe`` (S, D);
        ``seq``: the rank's sequence rows of them."""
        pe = pe.to(self.dtype)[None]
        if seq:
            pe = _rows(pe, current_mesh())
        return self._embed(params, tokens, seq) + pe

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

    def _forward(self, params, batch, train: bool = False,
                 decode_plan: bool = False):
        """(final-norm hidden states, the self K/V, the cross K/V); on a
        mesh ``decode_plan`` keeps the decoder's heads whole (the
        layout its caches are cut from).  Under sequence parallelism
        (``_seq_split``, the encoder's frames and the decoder's tokens
        each on their own) a stream between blocks is the rank's
        sequence shard; the final states are gathered whole."""
        mesh = current_mesh()
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        B, S = tokens.shape
        frames = batch["frames"]
        enc_seq = mesh is not None and self._seq_split(mesh, B,
                                                       frames.shape[1])
        seq = mesh is not None and self._seq_split(mesh, B, S)
        enc_out = self.encode(params, frames, train, seq=enc_seq)
        cross = self.cross_kv(params, enc_out, whole_heads=decode_plan,
                              seq=enc_seq)
        pos = torch.arange(S, device=self.device)[None].expand(B, S)
        x = self._embed_at(params, tokens,
                           C.sinusoid_pos(S, self.cfg.d_model, self.device),
                           seq)
        x, kvs = self._decoder(params, x, pos, cross, train=train,
                               whole_heads=decode_plan, seq=seq)
        return (self._final_norm(params["final_norm"], x, seq, mesh), kvs,
                cross)

    # ----------------------------------------------------------- serving
    def cache_specs(self, batch: int, seq_len: int) -> dict:
        """Specs of a cache (the reference's): self-attention K/V of
        capacity ``seq_len`` and cross K/V of ``n_frames``, bf16 on
        ``("batch", "kv_seq", "act_heads", None)``."""
        cfg = self.cfg

        def kv(s):
            return ParamSpec((batch, s, cfg.n_kv_heads, cfg.head_dim),
                             KV_AXES, dtype=torch.bfloat16)
        names = [f"dec_{i:02d}" for i in range(cfg.n_layers)]
        return {"self": {n: {"k": kv(seq_len), "v": kv(seq_len)}
                         for n in names},
                "cross": {n: (kv(cfg.n_frames), kv(cfg.n_frames))
                          for n in names},
                "pos": ParamSpec((), (), dtype=torch.int32)}

    def init_cache(self, batch: int, seq_len: int) -> dict:
        """An empty cache: zeros of ``cache_specs``, ``pos`` 0 (a 0-d
        int32 tensor)."""
        def zeros(ps):
            return torch.zeros(ps.shape, dtype=ps.dtype, device=self.device)
        specs = self.cache_specs(batch, seq_len)
        return {"self": {n: {k: zeros(ps) for k, ps in kv.items()}
                         for n, kv in specs["self"].items()},
                "cross": {n: tuple(map(zeros, kv))
                          for n, kv in specs["cross"].items()},
                "pos": C.decode_pos(0, self.device)}

    def prefill(self, params, batch, *, max_len: Optional[int] = None):
        """Encode + decoder prefill.  Returns (last-token logits (B, V),
        cache); ``max_len`` > S pads the self-attention caches.  On a
        mesh the cache is this rank's shard of the reference's layout
        (``cache_specs``; see ``shard_cache``)."""
        mesh = current_mesh()
        x, kvs, cross = self._forward(params, batch,
                                      decode_plan=mesh is not None)
        S = x.shape[1]
        if max_len is not None and max_len > S:
            for kv in kvs.values():
                for n in ("k", "v"):
                    c = kv[n]
                    kv[n] = torch.cat([c, c.new_zeros(
                        (c.shape[0], max_len - S) + c.shape[2:])], 1)
        last = self.logits(params, x[:, -1:])[:, 0]
        cache = {"self": kvs, "cross": cross,
                 "pos": C.decode_pos(S, self.device)}
        if mesh is not None:
            cache = self._cut_sequence(cache, mesh)
        return last, cache

    def _cache_shards(self, mesh, batch: int, seq: int, frames: int):
        return {"self": self._seq_shards(mesh, batch, [seq]),
                "cross": self._seq_shards(mesh, batch, [frames])}

    def shard_cache(self, cache, mesh) -> dict:
        """This rank's shard of a whole cache on ``mesh``, placed by
        ``cache_specs`` (the reference's ``tree_shardings(cache_specs)``:
        the self and cross K/V along their sequence); its
        ``seq_shards`` ({"self", "cross"}: how many ranks of ``model``
        split each) is what ``decode_step`` reads."""
        k0 = next(iter(cache["self"].values()))["k"]
        specs = self.cache_specs(k0.shape[0], k0.shape[1])
        out = spmd.shard_tree(cache, tree_shardings(specs, mesh), mesh)
        return {**out, "seq_shards": self._cache_shards(
            mesh, k0.shape[0], k0.shape[1], self.cfg.n_frames)}

    def _cut_sequence(self, cache, mesh):
        """A prefill's cache (this rank's batch rows, every position and
        head) -> this rank's sequence shard of each self and cross
        cache."""
        k0 = next(iter(cache["self"].values()))["k"]
        c0 = next(iter(cache["cross"].values()))[0]
        n = self._cache_shards(mesh, k0.shape[0] * mesh.axis_size(
            mesh.data_axes()), k0.shape[1], c0.shape[1])
        i = mesh.axis_index("model")

        def cut(t, m):
            step = t.shape[1] // m
            return t.narrow(1, i * step, step).contiguous()
        return {"self": {name: {k: cut(t, n["self"]) for k, t in kv.items()}
                         for name, kv in cache["self"].items()},
                "cross": {name: tuple(cut(t, n["cross"]) for t in kv)
                          for name, kv in cache["cross"].items()},
                "pos": cache["pos"], "seq_shards": n}

    def decode_step(self, params, cache, tokens):
        """One decoder token against the self- and cross-attention
        caches; writes its K/V in place.  Returns (logits (B, V), cache)
        with ``pos`` advanced.  On a mesh the cache is this rank's shard
        (``prefill`` or ``shard_cache``) and the tokens its batch rows;
        every head attends on every rank of ``model``, over the ranks'
        shards of each cache's sequence."""
        pos = C.decode_pos(cache["pos"], self.device)
        tokens = torch.as_tensor(tokens, device=self.device)
        B = tokens.shape[0]
        if current_mesh() is not None:
            # the mesh's decode places the cache's slots on the host
            # (sharded_decode_attention): one read of pos a step, eager
            at = int(cache["pos"])
        else:
            at = pos          # off a mesh no value of pos is read
        x = self._embed_at(params, tokens,
                           C.sinusoid_pos_at(pos.reshape(1), self.cfg.d_model))
        positions = pos.long().reshape(1, 1).expand(B, 1)
        sh = cache.get("seq_shards", {"self": 1, "cross": 1})
        x, _ = self._decoder(params, x, positions, cache["cross"],
                             caches=cache["self"], cache_pos=at,
                             seq_shards=(sh["self"], sh["cross"]))
        x = self._norm(params["final_norm"], x)
        # pos advances where the caller keeps it (the dry run's on the
        # CPU beside a model on meta)
        held = cache["pos"]
        cache["pos"] = held + 1 if isinstance(held, torch.Tensor) else pos + 1
        return self.logits(params, x)[:, 0], cache


def _rows(x, mesh):
    """This rank's sequence rows (dim 1) of an input every rank of
    ``model`` holds whole (frames, positions: nothing flows back)."""
    step = x.shape[1] // mesh.axis_size(spmd.MODEL)
    return x.narrow(1, mesh.axis_index(spmd.MODEL) * step, step)
