"""What every model of the port does on a mesh (``with mesh:``,
``launch/mesh.py``): place its leaves, split each attention's heads
over ``model`` (``_heads_split``: a rank's own run of whole query
heads, unevenly where ``model`` does not divide H; every head on every
rank where a cache is built or read and the heads do not split
evenly), and embed and unembed through a vocabulary that may be split
over ``model``.  ``DecoderLM`` and ``WhisperModel`` build on it;
``sharding/spmd.py`` says how a block computes over the mesh."""
from __future__ import annotations

from ..launch.mesh import current_mesh
from ..sharding import spmd
from ..sharding.collectives import gather
from ..sharding.rules import active_rules, logical_spec
from . import components as C

__all__ = ["MeshModel", "KV_AXES", "STREAM_AXES"]

#: the logical axes of an attention decode cache (the reference's)
KV_AXES = ("batch", "kv_seq", "act_heads", None)
#: the logical axes of the residual stream, as the reference's models
#: mark it at every block's output (``constrain``)
STREAM_AXES = ("batch", "seq", "act_embed")


class MeshModel:
    """Needs ``cfg``, ``device``, ``dtype`` and ``param_specs()``."""

    def placement(self, mesh) -> dict:
        """(spec, logical axes) of every parameter leaf on ``mesh``."""
        if getattr(self, "_placed", (None,))[0] is not mesh:
            self._placed = (mesh, spmd.placements(self.param_specs(), mesh))
        return self._placed[1]

    def _heads_split(self, mesh, attn, whole_heads: bool = False,
                     cache_step: bool = False) -> dict:
        """``spmd.TP``'s head fields for an attention placed as
        ``attn``: the rank's query heads (``spmd.rank_heads``; unevenly
        where ``model`` does not divide H), and its KV heads split too
        where ``model`` divides KVH.  Every head stays on every rank
        (``head_range`` None) in a prefill that builds a cache
        (``whole_heads``), and in a decode step (``cache_step``, whose
        cache holds every head) unless the KV heads split."""
        m, cfg = mesh.axis_size(spmd.MODEL), self.cfg
        h = cfg.n_heads
        kv = (h % m == 0 and cfg.n_kv_heads % m == 0
              and spmd.splits(attn["wk"][0], 1))
        if (whole_heads or (cache_step and not kv)
                or (h % m == 0 and not spmd.splits(attn["wq"][0], 1))):
            return {}
        return {**self._rank_heads(mesh), "kv": kv}

    def _rank_heads(self, mesh) -> dict:
        """``spmd.TP``'s fields for this rank's own query heads."""
        return {"head_range": spmd.rank_heads(
            self.cfg.n_heads, mesh.axis_size(spmd.MODEL),
            mesh.axis_index(spmd.MODEL)), "n_heads": self.cfg.n_heads}

    def _seq_split(self, mesh, rows: int, seq: int) -> bool:
        """Whether the residual stream of ``rows`` rows (this rank's
        batch rows) of ``seq`` positions lives on sequence shards over
        ``model`` (sequence parallelism): the active rules
        (``set_active_rules``) place ``STREAM_AXES``' ``seq`` on
        ``model``, which divides ``seq``.  Where it does not (a decode
        step's one position), the layout is the default one, as the
        reference's soft ``constrain`` falls back."""
        rows *= mesh.axis_size(mesh.data_axes())
        spec = logical_spec(STREAM_AXES, (rows, seq, self.cfg.d_model),
                            mesh, active_rules())
        return spmd.splits(spec, 1)

    def _seq_shards(self, mesh, batch: int, seqs) -> int:
        """How many ranks of ``model`` split the attention caches of
        ``batch`` rows (whole batch) and sequence lengths ``seqs`` (all
        split alike, or none)."""
        cfg, got = self.cfg, set()
        for seq in set(seqs):
            spec = logical_spec(KV_AXES, (batch, seq, cfg.n_kv_heads,
                                          cfg.head_dim), mesh)
            if spmd.splits(spec, 2):
                raise ValueError(
                    f"a decode cache of {seq} positions does not split "
                    f"over model={mesh.axis_size('model')}; its heads "
                    "would, which the port does not cover: give it a "
                    "length model divides")
            got.add(mesh.axis_size("model") if spmd.splits(spec, 1) else 1)
        if len(got) > 1:
            raise ValueError(f"decode caches of lengths {sorted(set(seqs))} "
                             "split over model unevenly")
        return got.pop() if got else 1

    def _embed_tp(self, mesh, seq: bool = False):
        place = self.placement(mesh)["embed"]
        return spmd.TP(mesh, vocab=spmd.splits(place["tok"][0], 0),
                       seq=seq), place

    def unembed_local(self, params, h):
        """(this rank's vocabulary slice of the logits of final-norm
        hidden states h, the slice's first vocabulary id): the
        vocab-parallel cross-entropy's input (``train/step.py``).  Off a
        mesh, or on one whose model axis does not split the vocabulary,
        the whole logits and 0."""
        mesh = current_mesh()
        if mesh is None:
            return self.logits(params, h), 0
        tp, place = self._embed_tp(mesh)
        p = spmd.localize(params["embed"], place, tp)
        if not tp.vocab:
            return C.unembed(p, h, self.cfg), 0
        out = C.unembed_local(p, h, self.cfg, tp)
        return out, tp.index * out.shape[-1]

    def _embed(self, params, tokens, seq: bool = False):
        """Token embeddings; ``seq``: this rank's sequence shard of them
        (sequence parallelism)."""
        mesh = current_mesh()
        p, tp = params["embed"], None
        if mesh is not None:
            tp, place = self._embed_tp(mesh, seq)
            p = spmd.localize(p, place, tp)
        return C.embed_tokens(p, tokens.to(self.device), self.cfg,
                              self.dtype, tp)

    def _final_norm(self, p, x, seq: bool, mesh):
        """The final norm of the residual stream, and under sequence
        parallelism (``seq``) the whole sequence of its states, gathered
        over ``model`` for the unembedding and the loss: the norm runs
        on the rank's rows, its leaves through ``fanout`` (their gradient
        summed over ``model``); the head's work is every rank's whole
        work, as without sequence parallelism, so the gather's backward
        keeps the rank's rows of a gradient every rank holds whole."""
        if not seq:
            return self._norm(p, x)
        tp = spmd.TP(mesh, seq=True)
        h = self._norm(C.fanout_tree(p, tp), x)
        return gather(h, mesh, spmd.MODEL, 1, split=False)

    def logits(self, params, h):
        """f32 logits of final-norm hidden states (..., D); on a mesh
        the whole vocabulary, gathered over ``model``."""
        mesh = current_mesh()
        if mesh is None:
            return C.unembed(params["embed"], h, self.cfg)
        tp, place = self._embed_tp(mesh)
        return C.unembed(spmd.localize(params["embed"], place, tp), h,
                         self.cfg, tp)
