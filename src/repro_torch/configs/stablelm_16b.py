"""stablelm-1.6b [dense] — 24L d=2048 32H (MHA kv=32) d_ff=5632
vocab=100352; LayerNorm + partial rotary (25%).
[hf:stabilityai/stablelm-2-1_6b; unverified]"""
from .base import ModelConfig

FULL = ModelConfig(
    name="stablelm-1.6b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=5632, vocab_size=100352,
    norm_kind="layernorm", norm_eps=1e-5, rope_fraction=0.25,
)

SMOKE = ModelConfig(
    name="stablelm-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256,
    norm_kind="layernorm", norm_eps=1e-5, rope_fraction=0.25,
    attn_kv_chunk=16,
)
