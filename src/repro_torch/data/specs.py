"""Model-input specifications for every (arch x shape) cell: the
reference's ``repro.data.specs``.

``train_specs`` returns (shape, dtype) stand-ins for a training or
prefill batch, ``train_axes`` their logical axes, ``decode_token_specs``
a decode step's tokens; no memory is allocated.  ``TensorSpec.meta()``
makes an empty tensor of the spec on the ``meta`` device, which the
dry run (``launch/dryrun.py``) traces with.  The synthetic pipeline
(``data/pipeline.py``) makes concrete batches of the same structure.

Modality frontends are stubs, as in the reference: whisper gets
precomputed frame embeddings, qwen2-vl precomputed patch embeddings
(both bf16) and int32 M-RoPE position ids.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

__all__ = ["TensorSpec", "train_specs", "train_axes", "decode_token_specs"]


class TensorSpec(NamedTuple):
    """A tensor's shape and dtype (the reference's
    ``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype

    def meta(self) -> torch.Tensor:
        return torch.empty(self.shape, dtype=self.dtype, device="meta")


def train_specs(cfg, batch: int, seq: int) -> Dict[str, TensorSpec]:
    """Training / prefill batch: tokens + labels (+ frontend stubs)."""
    specs = {
        "tokens": TensorSpec((batch, seq), torch.int32),
        "labels": TensorSpec((batch, seq), torch.int32),
    }
    if cfg.is_encoder_decoder:
        specs["frames"] = TensorSpec((batch, cfg.n_frames, cfg.d_model),
                                     torch.bfloat16)
    if cfg.rope_kind == "mrope":
        specs["mrope_positions"] = TensorSpec((batch, 3, seq), torch.int32)
    if cfg.n_patches:
        specs["patch_embeds"] = TensorSpec(
            (batch, cfg.n_patches, cfg.d_model), torch.bfloat16)
    return specs


def train_axes(cfg, batch: int, seq: int) -> Dict[str, Tuple]:
    """Logical axes for each entry of :func:`train_specs` (batch dim 0)."""
    axes = {
        "tokens": ("batch", None),
        "labels": ("batch", None),
    }
    if cfg.is_encoder_decoder:
        axes["frames"] = ("batch", None, None)
    if cfg.rope_kind == "mrope":
        axes["mrope_positions"] = ("batch", None, None)
    if cfg.n_patches:
        axes["patch_embeds"] = ("batch", None, None)
    return axes


def decode_token_specs(cfg, batch: int) -> Tuple[TensorSpec, Tuple]:
    """A decode step's tokens: (spec, logical axes)."""
    return TensorSpec((batch, 1), torch.int32), ("batch", None)
