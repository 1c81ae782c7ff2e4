"""Decoder-only LM of the port, the counterpart of
``repro.models.lm.DecoderLM``: every stack the reference builds as a
decoder — the scanned attention stacks it serves through its paged
engine (qwen3, qwen2, qwen1.5, stablelm, llama4-scout's MoE) and the
stacks it runs only on the contiguous-cache (lockstep) path:
deepseek-moe's leading dense layer before a scanned MoE stack,
qwen2-vl's M-RoPE with the patch-embedding stub, recurrentgemma's
unscanned (RG-LRU, RG-LRU, local attention) pattern with scaled
embeddings and soft-capped logits, and RWKV6's attention-free stack.

Parameters are a nested dict of tensors laid out exactly like the
reference's tree, so the weight bridge (``checkpoint/bridge.py``) is a
key-for-key copy: a stack of identical blocks is stacked on a leading
axis under ``layers`` (the reference's ``lax.scan`` layout), leading
dense layers are ``dense_layer_N``, and a heterogeneous stack is
unscanned, one ``layer_NN`` each.  A Python loop over layers takes the
place of ``lax.scan``; each layer reads views of the stacked tensors.

Entry points:

* ``apply``         logits over a whole sequence (whole-prompt prefill);
  ``train=True`` is the training forward (``train/step.py``), each
  layer rematerialised in the backward when ``cfg.remat == "full"``.
* ``prefill``       last-token logits + a contiguous decode cache.
* ``init_cache``    an empty contiguous cache (the draft model's).
* ``decode_step``   one token against the contiguous cache.
* ``prefill_chunk_paged`` / ``decode_step_paged`` / ``verify_step_paged``
  / ``fused_step_paged``  the serve engine's programs over the paged
  KV pool (``serve/kv_cache.py``), for the stacks that page
  (``supports_paged_decode``); given ``gather``, each is one shard's
  body of a tensor-parallel program (``serve/parallel.py``).

``apply`` and ``prefill`` take a (B, S) token tensor or, as the
reference does, a batch dict with ``tokens`` and optionally
``patch_embeds`` (B, n_patches, D) and ``mrope_positions`` (B, 3, S).

Caches and page pools are updated **in place** (the reference returns
new arrays); each program returns the state it was given.

Under ``with mesh:`` (``launch/mesh.py``) ``apply``, ``prefill`` and
``decode_step`` compute the rank's share of the whole batch: the
parameters are the rank's shards (``sharding.spmd.shard_tree`` by
``tree_shardings(param_specs())``), the batch rows the rank's rows of
the data axes, and each block is computed as ``sharding/spmd.py``
describes (FSDP gathers over ``data``; over ``model`` every block kind
splits: attention heads, FFN, experts, the RG-LRU width, RWKV6's heads
and channel mix).  ``cache_specs`` places a decode cache.  Under
``set_active_rules(SP_RULES)`` the residual stream between blocks is
the rank's sequence shard (Megatron's sequence parallelism,
``sharding/spmd.py``) wherever ``model`` divides the sequence length.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..device import resolve_device
from ..launch.mesh import current_mesh
from ..sharding import spmd
from ..sharding.rules import tree_shardings
from ..tree import tree_leaves, tree_map
from . import components as C
from . import rglru as R
from . import rwkv6 as W
from .base import ParamSpec, init_params, map_specs, with_param_dtype
from .meshed import KV_AXES, MeshModel

__all__ = ["DecoderLM", "param_specs"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _stack(tree, n: int):
    """Prefix every leaf's shape with a stacked layer axis of ``n``
    (logical axis ``"layers"``)."""
    if isinstance(tree, ParamSpec):
        return dataclasses.replace(tree, shape=(n,) + tuple(tree.shape),
                                   axes=("layers",) + tuple(tree.axes))
    return {k: _stack(v, n) for k, v in tree.items()}


def _first_dense(cfg) -> int:
    return cfg.moe.first_dense if cfg.moe is not None else 0


def _scanned(cfg) -> bool:
    """The reference's rule: the layers after the leading dense ones
    are stacked iff they are all of one kind."""
    return len(set(cfg.layer_kinds[_first_dense(cfg):])) == 1


def _block_specs(cfg, kind: str, use_moe: bool, dense_ff=None) -> dict:
    d = cfg.d_model
    if kind in ("attn", "local_attn"):
        mix = C.attn_specs(cfg)
    elif kind == "rglru":
        mix = R.rglru_block_specs(cfg)
    elif kind == "rwkv":
        mix = W.rwkv_time_specs(cfg)
    else:
        raise ValueError(f"{cfg.name}: unknown block kind {kind!r}")
    if kind == "rwkv":
        ffn = W.rwkv_ffn_specs(cfg)
    elif use_moe:
        ffn = C.moe_specs(cfg)
    else:
        ffn = C.mlp_specs(cfg, dense_ff)
    return {"ln1": C.norm_specs(d, cfg.norm_kind), "mix": mix,
            "ln2": C.norm_specs(d, cfg.norm_kind), "ffn": ffn}


def param_specs(cfg) -> dict:
    """The reference's parameter tree: a scanned stack under ``layers``
    (each leaf on a leading layer axis) after ``dense_layer_N`` leading
    dense layers (width ``moe.dense_d_ff``), or one ``layer_NN`` per
    layer; stored in ``cfg.param_dtype`` as the reference stores it
    (``base.with_param_dtype``, applied to the stacked tree)."""
    kinds, fd = cfg.layer_kinds, _first_dense(cfg)
    specs = {"embed": C.embed_specs(cfg),
             "final_norm": C.norm_specs(cfg.d_model, cfg.norm_kind)}
    if _scanned(cfg):
        specs["layers"] = _stack(
            _block_specs(cfg, kinds[-1], cfg.moe is not None),
            cfg.n_layers - fd)
        for i in range(fd):
            specs[f"dense_layer_{i}"] = _block_specs(
                cfg, kinds[i], False, cfg.moe.dense_d_ff)
    else:
        for i, kind in enumerate(kinds):
            specs[f"layer_{i:02d}"] = _block_specs(
                cfg, kind, cfg.moe is not None and i >= fd)
    return with_param_dtype(specs, cfg.param_dtype)


def _layer(tree, i: int):
    """Layer ``i``'s view of a layer-stacked parameter tree."""
    return tree_map(lambda t: t[i], tree)


class DecoderLM(MeshModel):
    """``wkv_prefill`` chooses the form of an RWKV6 prompt: "step" (the
    decode step's operations token by token, so a decode step extends a
    prefill bit for bit) or "chunked" (the reference's chunked-parallel
    WKV; see ``models/rwkv6.py``)."""

    def __init__(self, cfg, device=None, wkv_prefill: str = "step"):
        if cfg.is_encoder_decoder:
            raise ValueError(f"{cfg.name} is an encoder-decoder: build it "
                             "with repro_torch.models.build_model")
        for kind in set(cfg.layer_kinds):
            _block_specs(cfg, kind, False)       # raises on an unknown kind
        if wkv_prefill not in ("step", "chunked"):
            raise ValueError(f"wkv_prefill must be 'step' or 'chunked', "
                             f"got {wkv_prefill!r}")
        self.cfg = cfg
        self.wkv_chunked = wkv_prefill == "chunked"
        self.device = resolve_device(device)
        self.dtype = _DTYPES[cfg.compute_dtype]
        self.first_dense = _first_dense(cfg)
        self.scanned = _scanned(cfg)

    # ------------------------------------------------------------ params
    def param_specs(self) -> dict:
        return param_specs(self.cfg)

    def init(self, seed: int = 0, cast=None) -> dict:
        """Seeded random parameters on the model's device (the
        reference's distributions, not its bits); ``cast`` as in
        ``base.init_params``."""
        return init_params(self.param_specs(), seed, self.device, cast)

    def supports_paged_decode(self) -> bool:
        """The reference's condition: a scanned full-attention stack with
        no leading dense layer and no M-RoPE.  The others run on the
        contiguous-cache path only."""
        cfg = self.cfg
        return (self.scanned and self.first_dense == 0
                and set(cfg.layer_kinds) == {"attn"}
                and cfg.rope_kind != "mrope")

    def _blocks(self, params, place=None):
        """(kind, uses MoE, parameters, their placement or None) of
        every layer, in order."""
        cfg, fd = self.cfg, self.first_dense
        kinds = cfg.layer_kinds

        def at(name):
            return None if place is None else place[name]
        if self.scanned:
            for i in range(fd):
                name = f"dense_layer_{i}"
                yield kinds[i], False, params[name], at(name)
            lp = None if place is None else spmd.unstack(place["layers"])
            for i in range(cfg.n_layers - fd):
                yield (kinds[-1], cfg.moe is not None,
                       _layer(params["layers"], i), lp)
        else:
            for i, kind in enumerate(kinds):
                name = f"layer_{i:02d}"
                yield (kind, cfg.moe is not None and i >= fd, params[name],
                       at(name))

    # -------------------------------------------------------------- mesh
    # On a mesh (``with mesh:``, launch/mesh.py) every parameter is the
    # rank's shard of the leaf (``sharding.spmd.shard_tree``), batch rows
    # are the rank's rows of the data axes, and each block is computed
    # as ``sharding/spmd.py`` describes.  A one-rank mesh computes what
    # no mesh computes.
    def _tp(self, mesh, kind, pl, use_moe: bool, whole_heads: bool = False,
            cache_step: bool = False, seq_shards: int = 1,
            seq: bool = False):
        """The split over ``model`` of one ``kind`` block placed as
        ``pl``, as stored: attention heads as ``_heads_split`` says
        (``whole_heads``: a prefill that builds a cache;
        ``cache_step``: a decode step), the RG-LRU width, RWKV6's heads
        (where ``model`` divides H its states are cut by heads as they
        are computed, so neither flag applies; where it does not, the
        heads split unevenly only in a call that carries no state), the
        FFN's hidden dim, the experts; ``seq``: the residual stream on
        sequence shards (``_seq_split``)."""
        m = mesh.axis_size(spmd.MODEL)
        if m == 1:
            return spmd.TP(mesh)
        cfg = self.cfg
        mix, ffn = pl["mix"], pl["ffn"]
        if kind == "rwkv":
            # where model divides H its WKV state is cut by heads as it
            # is computed; an uneven split takes no state
            split = (spmd.splits(mix["wr"][0], 1) if cfg.n_heads % m == 0
                     else not (whole_heads or cache_step))
            return spmd.TP(mesh, **(self._rank_heads(mesh) if split else {}),
                           ff=spmd.splits(ffn["wk"][0], 1), seq=seq)
        heads, lru = {}, False
        if kind == "rglru":
            lru = spmd.splits(mix["w_in"][0], 1)
        else:
            heads = self._heads_split(mesh, mix, whole_heads, cache_step)
        if use_moe:
            return spmd.TP(mesh, **heads, experts=spmd.splits(
                ffn["wg"][0], 0), shared="shared" in ffn and spmd.splits(
                ffn["shared"]["wg"][0], 1), lru=lru, seq_shards=seq_shards,
                seq=seq)
        w = "w1" if cfg.mlp_kind == "gelu" else "wg"
        return spmd.TP(mesh, **heads, ff=spmd.splits(ffn[w][0], 1),
                       lru=lru, seq_shards=seq_shards, seq=seq)

    # ------------------------------------------------------------ blocks
    def _norm(self, p, x):
        return C.apply_norm(p, x, self.cfg.norm_kind, self.cfg.norm_eps)

    def _ffn(self, lp, x, gather=None):
        """The FFN sub-layer: an MoE block routes this call's rows (its
        capacity counted over them), else the dense MLP (its hidden dim
        gathered under tensor parallelism)."""
        h = self._norm(lp["ln2"], x)
        if self.cfg.moe is not None:
            f, _ = C.moe_block(lp["ffn"], h, self.cfg)
        else:
            f = C.mlp_block(lp["ffn"], h, self.cfg, gather)
        return x + f

    def _block(self, kind, use_moe, p, x, *, positions, mrope, cache,
               pos, train: bool = False, tp=None, pl=None):
        """One block on the contiguous path: prefill (``cache`` None)
        or one decode step at ``pos``; ``train``: the training forward
        (RWKV6 runs the reference's chunked WKV).  On a mesh ``p`` is
        the block's stored shards, placed as ``pl``, and ``tp`` its
        split over ``model``.  With ``tp.seq`` x is this rank's sequence
        shard: the norms and the residual adds run on it (the norms'
        leaves through ``fanout``, as each rank sees only its rows), and
        each sub-layer takes and returns the shard.  Returns (x, the
        layer's cache, the MoE's aux loss or None)."""
        cfg = self.cfg
        if tp is not None:
            p = spmd.localize(p, pl, tp)
            p = {**p, "ln1": C.fanout_tree(p["ln1"], tp),
                 "ln2": C.fanout_tree(p["ln2"], tp)}
        h = self._norm(p["ln1"], x)
        part = (lambda name: None) if cache is None else cache.get
        if kind in ("attn", "local_attn"):
            window = cfg.local_window if kind == "local_attn" else None
            mix, kv = C.attention_block(
                p["mix"], h, cfg, positions=positions, window=window,
                mrope_positions=mrope, cache=part("kv"), cache_pos=pos,
                paged=self.supports_paged_decode(), tp=tp)
            if window is not None and cache is None:   # prefill -> ring
                kv = {n: t[:, -window:].contiguous() for n, t in kv.items()}
            new = {"kv": kv}
        elif kind == "rglru":
            mix, rec = R.rglru_block(p["mix"], h, cfg, state=part("rec"),
                                     tp=tp)
            new = {"rec": rec}
        else:
            mix, att = W.rwkv_time_block(p["mix"], h, cfg,
                                         state=part("att"),
                                         chunked=self.wkv_chunked or train,
                                         tp=tp)
            new = {"att": att}
        x = x + mix
        h = self._norm(p["ln2"], x)
        aux = None
        if kind == "rwkv":
            f, new["ffn"] = W.rwkv_channel_block(p["ffn"], h, cfg,
                                                 state=part("ffn"), tp=tp)
        elif use_moe:
            f, aux = C.moe_block(p["ffn"], h, cfg, tp=tp)
        else:
            f = C.mlp_block(p["ffn"], h, cfg, tp=tp)
        return x + f, new, aux

    def _logits(self, params, x):
        return self.logits(params, self._norm(params["final_norm"], x))

    # ------------------------------------------------- contiguous path
    def _batch(self, batch):
        """(tokens (B, S), patch embeddings or None, M-RoPE positions or
        None) on the model's device.  Without ``mrope_positions`` an
        M-RoPE model takes text positions (all three ids = t), as a
        decode step does."""
        if not isinstance(batch, dict):
            batch = {"tokens": batch}
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        B, S = tokens.shape
        pe = batch.get("patch_embeds") if self.cfg.n_patches else None
        if pe is not None:
            pe = torch.as_tensor(pe, device=self.device)
        mrope = None
        if self.cfg.rope_kind == "mrope":
            mrope = batch.get("mrope_positions")
            mrope = (torch.arange(S, device=self.device)[None, None]
                     .expand(B, 3, S) if mrope is None
                     else torch.as_tensor(mrope, device=self.device))
        return tokens, pe, mrope

    def _forward(self, params, batch, train: bool = False,
                 decode_plan: bool = False):
        """Final-norm hidden states (B, S, D), every layer's cache (none
        with ``train``) and the MoE layers' summed aux loss (f32).  On a
        mesh ``decode_plan`` keeps every head on every rank of ``model``
        (the layout a decode cache is cut from); under sequence
        parallelism (``_seq_split``) the residual stream between the
        blocks, and so each layer's input that ``checkpoint`` keeps, is
        the rank's sequence shard (B, S / m, D), and the final states
        are gathered whole."""
        mesh = current_mesh()
        place = None if mesh is None else self.placement(mesh)
        tokens, pe, mrope = self._batch(batch)
        B, S = tokens.shape
        positions = torch.arange(S, device=self.device)[None].expand(B, S)
        seq = mesh is not None and self._seq_split(mesh, B, S)
        x = self._embed(params, tokens, seq)
        if pe is not None:
            # the VLM stub frontend: precomputed patch embeddings replace
            # the leading placeholder tokens (those of the rank's rows)
            off = mesh.axis_index(spmd.MODEL) * x.shape[1] if seq else 0
            n = max(0, min(pe.shape[1] - off, x.shape[1]))
            if n:
                x[:, :n] = pe[:, off:off + n].to(self.dtype)
        caches = []
        aux_total = torch.zeros((), dtype=torch.float32, device=self.device)
        if train and self.scanned:
            # one unbind a stacked leaf: its backward stacks the layers'
            # gradients in one op, where a view a layer would add a
            # zero-padded full-size gradient each
            params = {**params,
                      "layers": tree_map(torch.unbind, params["layers"])}
        for kind, use_moe, p, pl in self._blocks(params, place):
            tp = (None if mesh is None else
                  self._tp(mesh, kind, pl, use_moe, whole_heads=decode_plan,
                           seq=seq))
            if train:
                def layer(p, x, kind=kind, use_moe=use_moe, tp=tp, pl=pl):
                    y, _, aux = self._block(kind, use_moe, p, x,
                                            positions=positions,
                                            mrope=mrope, cache=None,
                                            pos=None, train=True, tp=tp,
                                            pl=pl)
                    return (y, aux) if use_moe else y
                if self.cfg.remat == "full":
                    # the reference's jax.checkpoint, every block kind:
                    # keep the layer's input, recompute the rest in the
                    # backward
                    out = C.remat(layer, p, x)
                else:
                    out = layer(p, x)
                if use_moe:
                    x, aux = out
                    aux_total = aux_total + aux
                else:
                    x = out
                continue
            x, c, aux = self._block(kind, use_moe, p, x,
                                    positions=positions, mrope=mrope,
                                    cache=None, pos=None, tp=tp, pl=pl)
            if aux is not None:
                aux_total = aux_total + aux
            caches.append(c)
        return (self._final_norm(params["final_norm"], x, seq, mesh), caches,
                aux_total)

    def apply(self, params, batch, *, train: bool = False,
              want_hidden: bool = False, want_aux: bool = False):
        """Whole-sequence forward: logits (B, S, V) f32, or with
        ``want_hidden`` the final-norm hidden states (B, S, D) (whose
        rows ``logits`` turns into logits); with ``want_aux`` also
        ``{"moe_aux": the MoE layers' summed load-balance loss}`` (the
        reference's ``aux_total``; 0 without an MoE).  ``train`` is the
        training forward: no caches, RWKV6's chunked WKV (the
        reference's training form), and with ``cfg.remat == "full"``
        each layer under ``torch.utils.checkpoint`` (the reference's
        ``jax.checkpoint``), so the backward recomputes it; where grad
        is enabled the kernels go through their autograd Functions.
        Without ``train`` it is the serving forward, bit for bit."""
        h, _, aux = self._forward(params, batch, train)
        out = h if want_hidden else self.logits(params, h)
        return (out, {"moe_aux": aux}) if want_aux else out

    def prefill(self, params, batch, *, max_len: Optional[int] = None):
        """Forward + contiguous decode cache.  Returns (last-token logits
        (B, V), cache ``{"layers": [one per layer], "pos": S}``, ``pos``
        a 0-d int32 tensor on the model's device);
        ``max_len`` > S pads the full-attention caches with decode
        headroom (ring buffers and recurrent states are fixed-size).
        On a mesh the cache is this rank's shard of the reference's
        layout (``cache_specs``: batch rows over the data axes, the
        sequence over ``model``; see ``shard_cache``)."""
        mesh = current_mesh()
        h, caches, _ = self._forward(params, batch,
                                     decode_plan=mesh is not None)
        S = h.shape[1]
        if max_len is not None and max_len > S:
            for kind, c in zip(self.cfg.layer_kinds, caches):
                if kind == "attn":
                    c["kv"] = {n: torch.cat([t, t.new_zeros(
                        (t.shape[0], max_len - S) + t.shape[2:])], 1)
                        for n, t in c["kv"].items()}
        cache = {"layers": caches, "pos": C.decode_pos(S, self.device)}
        if mesh is not None:
            cache = self._cut_sequence(cache, mesh)
        return self.logits(params, h[:, -1:])[:, 0], cache

    def _block_cache_specs(self, kind: str, batch: int,
                           seq_len: int) -> dict:
        cfg = self.cfg
        if kind in ("attn", "local_attn"):
            s = seq_len if kind == "attn" else min(cfg.local_window,
                                                   seq_len)
            shape = (batch, s, cfg.n_kv_heads, cfg.head_dim)
            kv = ParamSpec(shape, KV_AXES, dtype=torch.bfloat16)
            return {"kv": {"k": kv, "v": kv}}
        if kind == "rglru":
            return {"rec": R.rglru_state_specs(cfg, batch)}
        st = W.rwkv_state_specs(cfg, batch)
        return {"att": {"shift": st["att_shift"], "wkv": st["wkv"]},
                "ffn": {"shift": st["ffn_shift"]}}

    def cache_specs(self, batch: int, seq_len: int) -> dict:
        """Specs (shape, logical axes, dtype) of a decode cache of
        capacity ``seq_len``, in the port's cache layout (one entry a
        layer: the reference's, unstacked): attention K/V bf16 on
        ``("batch", "kv_seq", "act_heads", None)``, local attention a
        ring of min(window, seq_len) slots, recurrent states."""
        return {"layers": [self._block_cache_specs(k, batch, seq_len)
                           for k in self.cfg.layer_kinds],
                "pos": ParamSpec((), (), dtype=torch.int32)}

    def init_cache(self, batch: int, seq_len: int) -> dict:
        """An empty contiguous decode cache of capacity ``seq_len``
        (zeros of ``cache_specs``; ``pos`` a 0-d int32 tensor, 0)."""
        def zeros(ps):
            return torch.zeros(ps.shape, dtype=ps.dtype,
                               device=self.device)
        specs = self.cache_specs(batch, seq_len)
        return {"layers": [map_specs(zeros, c) for c in specs["layers"]],
                "pos": C.decode_pos(0, self.device)}

    def shard_cache(self, cache, mesh) -> dict:
        """This rank's shard of a whole decode cache on ``mesh``, placed
        by ``cache_specs`` (the reference's ``tree_shardings(
        cache_specs)``): recurrent states by width / heads, attention
        caches (rings included) along their sequence; its
        ``seq_shards`` tells ``decode_step`` how many ranks of ``model``
        split the attention caches' sequence."""
        kvs = [c["kv"]["k"] for c in cache["layers"] if "kv" in c]
        batch = tree_leaves(cache["layers"][0])[0].shape[0]
        seq = max((k.shape[1] for k in kvs), default=1)
        specs = self.cache_specs(batch, seq)
        out = spmd.shard_tree(cache, tree_shardings(specs, mesh), mesh)
        return {**out, "seq_shards": self._seq_shards(
            mesh, batch, [k.shape[1] for k in kvs])}

    def _cut_sequence(self, cache, mesh):
        """A prefill's cache (this rank's batch rows, every position;
        recurrent states already this rank's slice) -> this rank's
        sequence shard of each attention cache (a ring: of its
        slots)."""
        kvs = [c["kv"] for c in cache["layers"] if "kv" in c]
        if not kvs:
            return {**cache, "seq_shards": 1}
        batch = kvs[0]["k"].shape[0] * mesh.axis_size(mesh.data_axes())
        n = self._seq_shards(mesh, batch, [kv["k"].shape[1] for kv in kvs])
        if n > 1:
            i = mesh.axis_index("model")
            for c in cache["layers"]:
                if "kv" in c:
                    step = c["kv"]["k"].shape[1] // n
                    c["kv"] = {k: t.narrow(1, i * step, step).contiguous()
                               for k, t in c["kv"].items()}
        return {**cache, "seq_shards": n}

    def decode_step(self, params, cache, tokens):
        """One lockstep decode step: tokens (B, 1) at position
        ``cache["pos"]``.  Attention layers write this token's K/V into
        the cache in place; recurrent layers replace their state.
        Returns (logits (B, V), cache) with ``pos`` advanced.  On a mesh
        the cache is this rank's shard (``prefill`` or ``shard_cache``)
        and the tokens its batch rows; every head attends on every rank
        of ``model``, whose ranks split the cache's sequence
        (``components.sharded_decode_attention``).

        ``pos`` is a 0-d int32 tensor (the reference's traced scalar),
        and off a mesh the step reads no value of it on the host: the
        positions, the cache slot and the attention's lengths and
        offsets are arithmetic on the device, so one CUDA graph of the
        step replays at every position (``serve/step.py``,
        ``ServePrograms.lockstep``)."""
        cfg = self.cfg
        mesh = current_mesh()
        pos = C.decode_pos(cache["pos"], self.device)
        tokens = torch.as_tensor(tokens, device=self.device)
        B = tokens.shape[0]
        if mesh is not None:
            # the mesh's decode places the cache's slots on the host
            # (sharded_decode_attention: which rank writes, each
            # rank's offset): one read of pos a step, eager
            at = int(cache["pos"])
            positions = torch.full((B, 1), at, dtype=torch.long,
                                   device=self.device)
        else:
            at = pos
            positions = pos.long().reshape(1, 1).expand(B, 1)
        # text-only decode: all three M-RoPE ids advance with t
        mrope = (positions[:, None].expand(B, 3, 1)
                 if cfg.rope_kind == "mrope" else None)
        place = None if mesh is None else self.placement(mesh)
        x = self._embed(params, tokens)
        layers = cache["layers"]
        for i, (kind, use_moe, p, pl) in enumerate(
                self._blocks(params, place)):
            tp = None if mesh is None else self._tp(
                mesh, kind, pl, use_moe, cache_step=True,
                seq_shards=cache.get("seq_shards", 1))
            x, layers[i], _ = self._block(kind, use_moe, p, x,
                                          positions=positions, mrope=mrope,
                                          cache=layers[i], pos=at, tp=tp,
                                          pl=pl)
        # pos advances where the caller keeps it (the dry run's on the
        # CPU beside a model on meta)
        held = cache["pos"]
        cache["pos"] = held + 1 if isinstance(held, torch.Tensor) else pos + 1
        return self._logits(params, x)[:, 0], cache

    # ------------------------------------------------------ paged path
    # ``gather`` (every paged program): the tensor-parallel hook of
    # ``serve/parallel.py``, given when the model is one shard's view
    # (heads, KV heads and d_ff divided by tp); None on one device.
    def _check_tp(self, gather) -> None:
        if gather is not None and self.cfg.moe is not None:
            raise ValueError(f"{self.cfg.name}: tensor-parallel serving "
                             "does not cover MoE FFNs")

    def _verify_rows(self, params, xd, i, d_positions, state, gather):
        """Layer ``i`` of the decode/verify rows (T >= 1 tokens each)."""
        lp = _layer(params["layers"], i)
        h = self._norm(lp["ln1"], xd)
        xd = xd + C.paged_verify_attention_block(
            lp["mix"], h, self.cfg, positions=d_positions,
            k_pages=state["k_pages"][i], v_pages=state["v_pages"][i],
            page_table=state["page_tables"], lengths=state["lengths"],
            gather=gather)
        return self._ffn(lp, xd, gather)

    def _chunk_rows(self, params, xp, i, p_positions, state, table_rows,
                    starts, n_valid, gather):
        """Layer ``i`` of the chunked-prefill rows."""
        lp = _layer(params["layers"], i)
        h = self._norm(lp["ln1"], xp)
        xp = xp + C.paged_chunk_attention_block(
            lp["mix"], h, self.cfg, positions=p_positions, starts=starts,
            n_valid=n_valid, k_pages=state["k_pages"][i],
            v_pages=state["v_pages"][i], table_rows=table_rows,
            gather=gather)
        return self._ffn(lp, xp, gather)

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
                            starts, n_valid, gather=None):
        """Ingest one prompt chunk each for up to B requests (batched
        chunked prefill).  tokens (B, C): row b's token t sits at
        position ``starts[b] + t``; tokens t >= ``n_valid[b]`` are
        padding (written to the null page).  ``table_rows`` (B, nb):
        each row's page table cut to the dispatch's context bucket.
        Returns (last-valid-token logits (B, V), state)."""
        self._check_tp(gather)
        tokens, positions = self._paged_inputs(tokens, starts)
        x = self._embed(params, tokens)
        for i in range(self.cfg.n_layers):
            x = self._chunk_rows(params, x, i, positions, state, table_rows,
                                 starts, n_valid, gather)
        return self._last_logits(params, x, n_valid), state

    def verify_step_paged(self, params, state, tokens, gather=None):
        """Score T tokens per request against the paged cache: token t
        of row b sits at position ``lengths[b] + t`` and its K/V is
        written before attention.  T = 1 is the decode step.  Returns
        (logits (B, T, V), state) with ``lengths`` unchanged (the host
        owns them)."""
        self._check_tp(gather)
        tokens, positions = self._paged_inputs(tokens,
                                               state["lengths"])
        x = self._embed(params, tokens)
        for i in range(self.cfg.n_layers):
            x = self._verify_rows(params, x, i, positions, state, gather)
        return self._logits(params, x), state

    def decode_step_paged(self, params, state, tokens, gather=None):
        """One continuous-batching decode step, tokens (B, 1): the
        verify step at T = 1, so the two agree by construction.
        Returns (logits (B, V), state)."""
        if tokens.shape[1] != 1:
            raise ValueError("decode_step_paged takes one token per row")
        logits, state = self.verify_step_paged(params, state, tokens,
                                               gather)
        return logits[:, 0], state

    def fused_step_paged(self, params, state, d_tokens, p_tokens,
                         p_table_rows, p_starts, p_n_valid, gather=None):
        """Decode/verify every DECODING row AND ingest one chunk for
        every PREFILLING row in one program.  Each layer runs the
        prefill rows first, then the decode rows, on the in-place page
        pool: prefill gathers its own table prefix (which never holds a
        decode write target) before decode writes, and the two groups
        write disjoint (page, slot) targets, so each row is bit-identical
        to its unfused counterpart (``repro.models.lm.fused_step_paged``
        gives the disjointness argument).  An MoE layer routes each
        group on its own, with its capacity counted over that group's
        rows, as the reference does.  Returns ((d_logits (B, T, V),
        p_logits (Bp, V)), state)."""
        self._check_tp(gather)
        d_tokens, d_positions = self._paged_inputs(d_tokens,
                                                   state["lengths"])
        p_tokens, p_positions = self._paged_inputs(p_tokens,
                                                   p_starts)
        xd = self._embed(params, d_tokens)
        xp = self._embed(params, p_tokens)
        for i in range(self.cfg.n_layers):
            xp = self._chunk_rows(params, xp, i, p_positions, state,
                                  p_table_rows, p_starts, p_n_valid, gather)
            xd = self._verify_rows(params, xd, i, d_positions, state,
                                   gather)
        return ((self._logits(params, xd),
                 self._last_logits(params, xp, p_n_valid)), state)
