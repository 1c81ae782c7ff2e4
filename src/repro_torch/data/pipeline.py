"""Synthetic, stateless-resumable data pipeline: the reference's
``repro.data.pipeline.SyntheticPipeline``, draw for draw.

``batch_for_step(step)`` is a pure function of (seed, step, host): any
worker that knows the step number regenerates exactly its shard, so a
restart or an elastic rescale never replays or skips data.  The numpy
draws are the reference's, in its order, so both packages see the same
tokens at the same step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ..device import resolve_device
from ..sharding.rules import logical_spec

__all__ = ["SyntheticPipeline"]


@dataclasses.dataclass(frozen=True)
class SyntheticPipeline:
    cfg: object                    # ModelConfig
    batch: int
    seq: int
    seed: int = 0
    n_hosts: int = 1
    host_index: int = 0

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_index]))

    def host_batch(self) -> int:
        if self.batch % self.n_hosts:
            raise ValueError(f"batch {self.batch} does not split over "
                             f"{self.n_hosts} hosts")
        return self.batch // self.n_hosts

    def batch_for_step(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = self._rng(step)
        b, s = self.host_batch(), self.seq
        v = cfg.vocab_size
        # markov-ish stream so loss actually decreases in the examples
        base = rng.integers(0, v, size=(b, 1), dtype=np.int32)
        drift = rng.integers(0, 17, size=(b, s), dtype=np.int32)
        tokens = (base + np.cumsum(drift, axis=1)) % v
        batch = {
            "tokens": tokens.astype(np.int32),
            "labels": np.roll(tokens, -1, axis=1).astype(np.int32),
        }
        if cfg.is_encoder_decoder:
            batch["frames"] = rng.standard_normal(
                (b, cfg.n_frames, cfg.d_model)).astype(np.float32)
        if cfg.rope_kind == "mrope":
            pos = np.broadcast_to(np.arange(s, dtype=np.int32),
                                  (b, 3, s)).copy()
            batch["mrope_positions"] = pos
        if cfg.n_patches:
            batch["patch_embeds"] = rng.standard_normal(
                (b, cfg.n_patches, cfg.d_model)).astype(np.float32)
        return batch

    def device_batch(self, step: int, device=None,
                     mesh=None) -> Dict[str, torch.Tensor]:
        """``batch_for_step(step)`` as tensors on ``device`` (default:
        the GPU): int32 leaves as they are, float inputs as bf16, as the
        reference's ``device_batch`` casts them.  With a ``mesh`` (the
        reference's ``shardings``) this rank's rows of the data axes
        (the logical ``batch`` dim), on the mesh's device."""
        dev = resolve_device(mesh.device if mesh is not None else device)
        out = {}
        for k, v in self.batch_for_step(step).items():
            t = torch.from_numpy(v)
            if mesh is not None:
                t = mesh.shard(t, logical_spec(
                    ("batch",) + (None,) * (t.dim() - 1), t.shape, mesh))
            out[k] = (t.to(dev) if v.dtype == np.int32
                      else t.to(device=dev, dtype=torch.bfloat16))
        return out
