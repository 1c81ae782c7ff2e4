"""qwen2-vl-7b [vlm] — 28L d=3584 28H (GQA kv=4) d_ff=18944
vocab=152064; M-RoPE (t/h/w sections 16/24/24); vision frontend is a
stub (precomputed patch embeddings spliced over the leading tokens).
[arXiv:2409.12191; hf]"""
from .base import ModelConfig

FULL = ModelConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, head_dim=128,
    d_ff=18944, vocab_size=152064,
    qkv_bias=True, rope_kind="mrope", rope_theta=1e6,
    mrope_sections=(16, 24, 24), n_patches=256,
)

SMOKE = ModelConfig(
    name="qwen2-vl-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256,
    qkv_bias=True, rope_kind="mrope", rope_theta=1e6,
    mrope_sections=(2, 3, 3), n_patches=8, attn_kv_chunk=16,
)
