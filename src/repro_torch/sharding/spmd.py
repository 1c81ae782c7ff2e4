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
Every block kind splits over ``model`` where its work does:

* attention heads (``q_heads``; ``kv_heads`` too when ``model`` divides
  KVH) column-parallel, ``wo`` row-parallel, unevenly where ``model``
  does not divide H (below); whisper's encoder, decoder and
  cross-attention alike (the cross K/V column-parallel from the encoder
  output);
* the FFN's hidden dim (``ff``) column-parallel, ``wd`` / ``w2``
  row-parallel; RWKV6's channel mix the same (``wk`` / ``wv``), its
  gate ``wr`` duplicated;
* the RG-LRU width (``ff``: ``w_gate``, ``w_in``, the conv, the rows of
  the gates ``wr`` / ``wi`` and of ``w_out``; ``TP.lru``): the conv and
  the scan per channel on the rank's slice, the gates' f32 partial
  products reduce-scattered (``collectives.Scatter``);
* RWKV6's heads (``q_heads`` on ``wr/wk/wv/wg/wo``, ``act_heads`` on
  ``u`` and the group norm): the WKV on the rank's heads, the token mix
  and the decay LoRA duplicated and sliced;
* experts expert-parallel (``expert``), the shared expert on ``ff``;
* the vocabulary (``vocab``) in the embedding, the unembedding and the
  cross-entropy.

An activation replicated over ``model`` that enters split products
goes through ``components.fanout_linear``: its gradient's f32 partials
are summed over ``model`` before their one rounding, as the single
device rounds its one product.  A replicated vector that feeds split
work (a bias, RG-LRU's ``lam``) enters through ``Fanout`` before the
rank's slice is cut, so its gradient is the sum over ``model``; one
that feeds duplicated work (a bias added after a row-parallel sum,
RWKV6's ``mu_*``) gets the whole gradient on every rank as it is.

Where ``model`` does not divide H a rank computes its own contiguous
run of whole query heads (``rank_heads``: rank r holds [ceil(r H / m),
ceil((r + 1) H / m)), so rank 0 holds the most, ceil(H / m), and where
m > H some ranks hold none), with the matching rows of ``wo``, as the
reference's column shards of the flattened ``q_heads`` leave each
device about H / m heads (``TP.head_range``, ``TP.cut``).  A stored
shard of H Dh / m columns is not a run of whole heads there, so
``localize`` gathers the leaf over ``model`` with ``split=True``
(backward: a reduce-scatter, each shard's gradient summed over the
ranks that read it), or takes a replicated one through ``fanout``, and
cuts the rank's heads: the columns of ``wq`` and RWKV6's
``wr/wk/wv/wg``, the rows of ``wo`` and of RWKV6's ``u`` and group norm.
Replicated vectors laid out by head (QKV biases, RWKV6's decay LoRA
output) are cut where they are read (``components.rank_slice``).  A rank
with no heads makes every collective the others make, on empty
tensors, launches no attention kernel and no Q/K/V product, and adds
zeros to ``wo``'s sum.  Where ``model`` divides H the stored shard is
the rank's heads and nothing is gathered.

Where ``model`` does not divide KVH (split heads, even or not) the KV
projections are gathered (backward: a reduce-scatter), a rank projects
only the KV heads its query heads read (``rank_kv_heads``: its columns
of the gathered ``wk`` / ``wv`` taken before the product) and repeats
them G-fold to its query heads, as the reference's
``_gqa_expand_factor`` repeats its column shard.

Whatever carries a cache or a state keeps every head on every rank of
``model`` where ``model`` does not divide H, as the reference's cache
specs replicate the head dim there: a decode step, a prefill that builds
a cache, an RWKV6 call with a state.  ``localize`` then gathers the
attention's projections (backward: the rank's own slice, as the work is
duplicated).  So does a decode step where ``model`` divides H but not
KVH (a decode cache holds every head, split along its sequence).  A
decode step whose heads split gathers its q, k, v heads instead
(``components.attention_block``).  Recurrent states (RG-LRU, RWKV6) are
cut by width / heads as they are computed.

**Sequence parallelism** (``TP.seq``; ``SP_RULES`` active and
``model`` dividing the sequence length, ``MeshModel._seq_split``):
Megatron's layout.  Between blocks the residual stream is the rank's
sequence shard (B, S / m, D), so each layer's input that
``checkpoint`` keeps is S / m long; the norms and the residual adds run
on it, their leaves (and a bias added after a row-parallel sum)
through ``fanout`` in f32, since each rank's gradient of them is its
rows' share.  A block's split work starts from the whole sequence:

* a column-parallel entry (``fanout_linear``: attention's QKV, the
  FFN's up projections, the RG-LRU's gate and input, whisper's cross
  K/V from the encoder's shard) all-gathers the shard and
  reduce-scatters the f32 partials of its input's gradient (the
  all-reduce's sum, each rank keeping its rows), then rounds once;
* a row-parallel exit (``row_parallel``: ``wo``, ``wd`` / ``w2``,
  ``w_out``, RWKV6's ``wo`` / ``wv``; the MoE's and the shared
  expert's sums; the vocab-parallel embedding) reduce-scatters along
  the sequence instead of all-reducing (``Scatter``, backward an
  all-gather);
* work that does not split (a hidden dim or width ``model`` does not
  divide; heads in a prefill that builds a cache) gathers the sequence with
  its gradient cut to the rank's rows, runs whole as without sequence
  parallelism, and keeps the rank's rows of its output
  (``components.whole_sequence``, ``collectives.Split``); so do the
  blocks whose whole-sequence work comes first: the MoE (routing and
  capacity over the call's rows, as without sequence parallelism) and
  RWKV6's token shift, token mix, decay LoRA and channel-mix gate,
  whose split products' sums still leave reduce-scattered; no state
  crosses ranks;
* the unembedding and the cross-entropy read the final norm's states
  gathered whole.

A decode step (one position) and a sequence ``model`` does not divide
keep the default layout, bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from .collectives import fanout, gather
from .rules import logical_spec, spec_axes

__all__ = ["TP", "localize", "splits", "MODEL", "rank_heads",
           "rank_kv_heads", "placements", "unstack", "shard_tree",
           "unshard_tree", "shard_shapes"]

MODEL = ("model",)


#: the logical axes laid out by query head (``localize`` cuts a rank's
#: heads of them where ``model`` does not divide H)
HEAD_AXES = ("q_heads", "act_heads")


@dataclasses.dataclass(frozen=True)
class TP:
    """One block's split over ``model`` on ``mesh``."""
    mesh: Any
    head_range: Optional[range] = None   # the rank's query heads; None: whole
    n_heads: int = 0         # H, where head_range is given
    kv: bool = False         # KV heads split too (else expanded)
    ff: bool = False         # the dense FFN's hidden dim
    experts: bool = False    # expert parallelism
    shared: bool = False     # the shared expert's hidden dim
    lru: bool = False        # the RG-LRU width
    vocab: bool = False      # vocab-parallel embedding / unembedding
    seq_shards: int = 1      # decode cache: kv_seq split over model
    seq: bool = False        # SP: input and output are sequence shards

    @property
    def size(self) -> int:
        return self.mesh.axis_size(MODEL)

    @property
    def index(self) -> int:
        return self.mesh.axis_index(MODEL)

    @property
    def heads(self) -> bool:
        """Whether this rank computes only its query heads."""
        return self.head_range is not None

    @property
    def cut(self) -> bool:
        """Whether the heads split unevenly (``model`` does not divide
        H): the stored head shards are not the rank's heads, so
        ``localize`` gathers and cuts them."""
        return self.heads and self.n_heads % self.size != 0


def rank_heads(n_heads: int, size: int, index: int) -> range:
    """The query heads rank ``index`` of ``size`` along ``model``
    computes: [ceil(index H / size), ceil((index + 1) H / size)), so the
    ranks tile [0, H) in order, rank 0 holds ceil(H / size) (the most),
    a rank holds none where size > H, and where ``size`` divides H rank
    r holds [r H / size, (r + 1) H / size)."""
    return range(-(-index * n_heads // size),
                 -(-(index + 1) * n_heads // size))


def rank_kv_heads(n_heads: int, n_kv_heads: int, size: int,
                  index: int) -> range:
    """The KV heads that rank ``index`` of ``size`` along ``model``
    reads, its query heads being ``rank_heads``: query head j reads KV
    head j // G (G = n_heads / n_kv_heads), so one head where the
    rank's heads lie in one group, else several, a head at a boundary
    read by both neighbours; none for a rank with no query heads."""
    g, q = n_heads // n_kv_heads, rank_heads(n_heads, size, index)
    if not q:
        return range(q.start // g, q.start // g)
    return range(q.start // g, (q.stop - 1) // g + 1)


def splits(spec, dim: int) -> bool:
    """Whether dim ``dim`` of a ``logical_spec`` tuple is split over
    ``model``."""
    return dim < len(spec) and "model" in spec_axes(spec[dim])


def localize(tree, place, tp):
    """A block's stored shards -> the tensors its computation reads:
    every data-sharded dim gathered (backward: reduce-scatter), and
    over ``model`` the heads gathered where ``tp`` does not split them,
    or gathered (a replicated leaf fanned out) and cut to the rank's
    heads where it splits them unevenly (``TP.cut``; that dim first,
    so the data gathers move only the rank's heads).  ``place`` mirrors
    ``tree`` with (spec, logical axes) leaves."""
    if isinstance(tree, dict):
        return {k: localize(v, place[k], tp) for k, v in tree.items()}
    spec, axes = place
    mesh = tp.mesh
    t = tree
    dims = range(len(axes))
    if tp.cut:
        dims = sorted(dims, key=lambda d: axes[d] not in HEAD_AXES)
    for dim in dims:
        ax = spec_axes(spec[dim]) if dim < len(spec) else ()
        on_model = "model" in ax and mesh.axis_size(ax) > 1
        name = axes[dim]
        if ax and mesh.axis_size(ax) > 1 and not on_model:
            t = gather(t, mesh, ax, dim, split=True)
        elif name in HEAD_AXES and tp.cut:
            t = (gather(t, mesh, ax, dim, split=True) if on_model
                 else fanout(t, mesh, MODEL))
            width = t.shape[dim] // tp.n_heads
            t = t.narrow(dim, tp.head_range.start * width,
                         len(tp.head_range) * width)
        elif name == "kv_heads" and tp.heads and not tp.kv:
            # the rank's KV heads are cut from the whole leaf where they
            # are read (split work: each column's gradient summed over
            # its readers)
            t = (gather(t, mesh, ax, dim, split=True) if on_model
                 else fanout(t, mesh, MODEL))
        elif on_model and not tp.heads and name in (*HEAD_AXES,
                                                    "kv_heads"):
            # a whole attention is duplicated work
            t = gather(t, mesh, ax, dim, split=False)
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


def shard_shapes(tree, specs, shardings, mesh) -> list:
    """(path, shape, the shape ``shard`` cuts from its spec under
    ``shardings``) of every tensor of ``tree``, a tree of this rank's
    pieces of ``specs`` (``ParamSpec``s) as a model made them (a
    prefill's cache on the mesh); leaves that are not tensors, and keys
    ``specs`` lacks (a cache's ``pos``, ``seq_shards``), left out."""
    out = []

    def walk(t, ps, sh, path):
        if isinstance(t, torch.Tensor):
            want = tuple(n // mesh.axis_size(spec_axes(sh[i]))
                         if i < len(sh) else n
                         for i, n in enumerate(ps.shape))
            out.append((path, tuple(t.shape), want))
        elif isinstance(t, dict):
            for k in t:
                if k in ps:
                    walk(t[k], ps[k], sh[k], f"{path}/{k}")
        elif isinstance(t, (list, tuple)):
            for i, (c, p, h) in enumerate(zip(t, ps, sh)):
                walk(c, p, h, f"{path}/{i}")
    walk(tree, specs, shardings, "")
    return out


def _map_leaves(tree, shardings, fn):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, shardings[k], fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(v, s, fn)
                          for v, s in zip(tree, shardings))
    if isinstance(tree, torch.Tensor):
        return fn(tree, shardings)
    return tree
