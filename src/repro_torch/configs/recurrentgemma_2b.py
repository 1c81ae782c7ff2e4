"""recurrentgemma-2b [hybrid] — 26L d=2560 10H (MQA kv=1) d_ff=7680
vocab=256000; Griffin pattern: (RG-LRU, RG-LRU, local-attn) with a
2048 window.  Sub-quadratic -> eligible for long_500k.
[arXiv:2402.19427; hf]"""
from .base import ModelConfig

FULL = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7680, vocab_size=256000,
    block_pattern=("rglru", "rglru", "local_attn"),
    local_window=2048, lru_width=2560,
    tie_embeddings=True, scale_embeddings=True, logit_softcap=30.0,
    sub_quadratic=True,
)

SMOKE = ModelConfig(
    name="recurrentgemma-smoke", family="hybrid",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=128, vocab_size=256,
    block_pattern=("rglru", "rglru", "local_attn"),
    local_window=16, lru_width=64,
    tie_embeddings=True, scale_embeddings=True, logit_softcap=30.0,
    sub_quadratic=True, attn_kv_chunk=16,
)
