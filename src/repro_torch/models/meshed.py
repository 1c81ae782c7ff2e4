"""What every model of the port does on a mesh (``with mesh:``,
``launch/mesh.py``): place its leaves, and embed and unembed through a
vocabulary that may be split over ``model``.  ``DecoderLM`` and
``WhisperModel`` build on it; ``sharding/spmd.py`` says how a block
computes over the mesh."""
from __future__ import annotations

from ..launch.mesh import current_mesh
from ..sharding import spmd
from . import components as C

__all__ = ["MeshModel"]


class MeshModel:
    """Needs ``cfg``, ``device``, ``dtype`` and ``param_specs()``."""

    def placement(self, mesh) -> dict:
        """(spec, logical axes) of every parameter leaf on ``mesh``;
        refuses a model axis the stack cannot split over."""
        if getattr(self, "_placed", (None,))[0] is not mesh:
            spmd.check_model_axis(self.cfg, mesh, self.cfg.layer_kinds)
            self._placed = (mesh, spmd.placements(self.param_specs(), mesh))
        return self._placed[1]

    def _embed_tp(self, mesh):
        place = self.placement(mesh)["embed"]
        return spmd.TP(mesh, vocab=spmd.splits(place["tok"][0], 0)), place

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

    def _embed(self, params, tokens):
        mesh = current_mesh()
        p, tp = params["embed"], None
        if mesh is not None:
            tp, place = self._embed_tp(mesh)
            p = spmd.localize(p, place, tp)
        return C.embed_tokens(p, tokens.to(self.device), self.cfg,
                              self.dtype, tp)

    def logits(self, params, h):
        """f32 logits of final-norm hidden states (..., D); on a mesh
        the whole vocabulary, gathered over ``model``."""
        mesh = current_mesh()
        if mesh is None:
            return C.unembed(params["embed"], h, self.cfg)
        tp, place = self._embed_tp(mesh)
        return C.unembed(spmd.localize(params["embed"], place, tp), h,
                         self.cfg, tp)
