"""How a model computes over a mesh: each block's split over ``model``
(``TP``) and the hook that turns a block's stored shards into the
tensors its computation reads (``localize``).

**Storage** is ``logical_spec``'s: every rank holds exactly its shard of
every leaf (``launch.mesh.Mesh.shard``).  A dim sharded over the data
axes (``embed`` -> ``data``) is FSDP storage; a dim sharded over
``model`` is computed sharded.

**Compute.**  ``localize`` gathers every data-sharded dim where a
layer's slice is taken (``Gather``: backward a reduce-scatter, so the
gradient arrives summed over the data ranks and cut to the shard).
Over ``model`` a block computes on its shard where its work splits:

* attention heads (``q_heads``; ``kv_heads`` too when ``model`` divides
  KVH) column-parallel, ``wo`` row-parallel;
* the FFN's hidden dim (``ff``) column-parallel, ``wd`` / ``w2``
  row-parallel;
* experts expert-parallel (``expert``), the shared expert on ``ff``;
* the vocabulary (``vocab``) in the embedding, the unembedding and the
  cross-entropy.

Where the heads do not split (``model`` does not divide H, or KVH in a
decode step, or a prefill builds a cache: a decode cache holds every
head, split along its sequence instead) the attention runs whole on
every rank of ``model``: ``localize`` gathers its projections
(backward: the rank's own slice, as the work was duplicated).  A decode
step whose heads split gathers its q, k, v heads instead
(``components.attention_block``).  Where ``model`` divides H but not KVH the KV projections
are gathered and their heads repeated G-fold before this rank's heads
are taken (the reference's ``_gqa_expand_factor``).

Only the DecoderLM stacks of attention blocks split over ``model``;
whisper, recurrentgemma and rwkv6 refuse a ``model`` axis wider than 1
(``check_model_axis``) and train with FSDP over ``data``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .collectives import gather
from .rules import logical_spec, spec_axes

__all__ = ["TP", "localize", "splits", "check_model_axis", "MODEL",
           "placements", "unstack", "shard_tree", "unshard_tree"]

MODEL = ("model",)


@dataclasses.dataclass(frozen=True)
class TP:
    """One block's split over ``model`` on ``mesh``."""
    mesh: Any
    heads: bool = False      # attention heads column-parallel
    kv: bool = False         # KV heads split too (else expanded)
    ff: bool = False         # the dense FFN's hidden dim
    experts: bool = False    # expert parallelism
    shared: bool = False     # the shared expert's hidden dim
    vocab: bool = False      # vocab-parallel embedding / unembedding
    seq_shards: int = 1      # decode cache: kv_seq split over model

    @property
    def size(self) -> int:
        return self.mesh.axis_size(MODEL)

    @property
    def index(self) -> int:
        return self.mesh.axis_index(MODEL)


def splits(spec, dim: int) -> bool:
    """Whether dim ``dim`` of a ``logical_spec`` tuple is split over
    ``model``."""
    return dim < len(spec) and "model" in spec_axes(spec[dim])


def check_model_axis(cfg, mesh, kinds) -> None:
    """Refuse a ``model`` axis wider than 1 for the blocks whose tensor
    parallelism is not ported."""
    if mesh is None or mesh.axis_size(MODEL) == 1:
        return
    other = sorted(set(kinds) - {"attn"})
    if cfg.is_encoder_decoder or other:
        what = "an encoder-decoder" if cfg.is_encoder_decoder else \
            f"{other} blocks"
        raise ValueError(
            f"{cfg.name}: {what} on a model axis of "
            f"{mesh.axis_size(MODEL)}: tensor parallelism covers the "
            "DecoderLM attention stacks only (ROADMAP Queue 1 item 14c); "
            "use a (n, 1) mesh (FSDP over data)")


def localize(tree, place, tp):
    """A block's stored shards -> the tensors its computation reads:
    every data-sharded dim gathered (backward: reduce-scatter), and
    over ``model`` the heads gathered where ``tp`` does not split them.
    ``place`` mirrors ``tree`` with (spec, logical axes) leaves."""
    if isinstance(tree, dict):
        return {k: localize(v, place[k], tp) for k, v in tree.items()}
    spec, axes = place
    mesh = tp.mesh
    t = tree
    for dim, entry in enumerate(spec):
        ax = spec_axes(entry)
        if not ax or mesh.axis_size(ax) == 1:
            continue
        if "model" not in ax:
            t = gather(t, mesh, ax, dim, split=True)
        elif axes[dim] == "q_heads" and not tp.heads:
            t = gather(t, mesh, ax, dim, split=False)
        elif axes[dim] == "kv_heads" and not tp.kv:
            # the expanded KV of split heads is split work; a whole
            # attention is duplicated work
            t = gather(t, mesh, ax, dim, split=tp.heads)
    return t


def placements(spec_tree, mesh):
    """A ``ParamSpec`` tree -> the same tree of (``logical_spec`` tuple,
    logical axes) pairs on ``mesh`` (``localize``'s ``place``)."""
    if isinstance(spec_tree, dict):
        return {k: placements(v, mesh) for k, v in spec_tree.items()}
    return (logical_spec(spec_tree.axes, spec_tree.shape, mesh),
            tuple(spec_tree.axes))


def unstack(place):
    """The placement of one layer of a layer-stacked placement tree
    (its leading ``"layers"`` dim dropped)."""
    if isinstance(place, dict):
        return {k: unstack(v) for k, v in place.items()}
    spec, axes = place
    return spec[1:], axes[1:]


def shard_tree(tree, shardings, mesh):
    """This rank's shards of a tree of full tensors (dicts, lists and
    tuples walked; a leaf that is not a tensor, as a cache's ``pos``,
    kept), by a matching tree of ``logical_spec`` tuples
    (``tree_shardings``)."""
    return _map_leaves(tree, shardings, mesh.shard)


def unshard_tree(tree, shardings, mesh):
    """The full tensors of a tree of shards (every rank must call it)."""
    return _map_leaves(tree, shardings, mesh.unshard)


def _map_leaves(tree, shardings, fn):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, shardings[k], fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(v, s, fn)
                          for v, s in zip(tree, shardings))
    if isinstance(tree, torch.Tensor):
        return fn(tree, shardings)
    return tree
