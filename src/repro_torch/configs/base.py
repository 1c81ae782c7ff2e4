"""Model config schema and the assigned input shapes (the port's own
copy of ``repro.configs.base``)."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

__all__ = ["MoEConfig", "ModelConfig", "ShapeSpec", "SHAPES", "shape_by_name"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert_ff: int
    n_shared: int = 0                # shared experts (always-on), units of d_expert_ff
    capacity_factor: float = 1.25
    normalize_router: bool = True
    first_dense: int = 0             # leading layers with a dense FFN instead
    dense_d_ff: int = 0              # d_ff of those dense layers
    aux_coef: float = 0.01


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // n_heads
    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_kind: str = "rope"           # rope | mrope | none
    rope_theta: float = 1e4
    rope_fraction: float = 1.0
    mrope_sections: Tuple[int, ...] = ()
    attn_kv_chunk: int = 1024
    local_window: int = 2048
    # block structure
    block_pattern: Tuple[str, ...] = ("attn",)   # attn | local_attn | rglru | rwkv
    mlp_kind: str = "swiglu"          # swiglu | gelu
    norm_kind: str = "rmsnorm"        # rmsnorm | layernorm
    norm_eps: float = 1e-6
    moe: Optional[MoEConfig] = None
    lru_width: int = 0
    # embeddings
    tie_embeddings: bool = False
    scale_embeddings: bool = False
    logit_softcap: float = 0.0
    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    n_frames: int = 1500
    # vlm stub frontend
    n_patches: int = 0
    # training knobs
    train_microbatch: int = 0
    remat: str = "full"
    loss_chunk: int = 0
    param_dtype: str = "float32"
    grad_accum_dtype: str = "float32"
    sub_quadratic: bool = False
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        return tuple(self.block_pattern[i % len(self.block_pattern)]
                     for i in range(self.n_layers))

    def n_params(self) -> int:
        """Total parameter count, from the port's own parameter specs."""
        from ..models import param_specs
        from ..models.base import flatten_specs
        return sum(math.prod(ps.shape)
                   for _, ps in flatten_specs(param_specs(self)))

    def n_active_params(self) -> int:
        """Parameters one token uses: an MoE layer's routed top-k and
        shared experts, not its other routed experts."""
        total = self.n_params()
        if self.moe is None:
            return total
        m = self.moe
        per_expert = 3 * self.d_model * m.d_expert_ff
        n_moe_layers = self.n_layers - m.first_dense
        return total - n_moe_layers * (m.n_experts - m.top_k) * per_expert


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                         # train | prefill | decode


SHAPES = (
    ShapeSpec("train_4k", 4096, 256, "train"),
    ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    ShapeSpec("decode_32k", 32768, 128, "decode"),
    ShapeSpec("long_500k", 524288, 1, "decode"),
)


def shape_by_name(name: str) -> ShapeSpec:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)
