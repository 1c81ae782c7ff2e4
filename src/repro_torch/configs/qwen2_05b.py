"""qwen2-0.5b [dense] — 24L d=896 14H (GQA kv=2) d_ff=4864
vocab=151936, QKV bias, tied embeddings.  [arXiv:2407.10671; hf]"""
from .base import ModelConfig

FULL = ModelConfig(
    name="qwen2-0.5b", family="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, head_dim=64,
    d_ff=4864, vocab_size=151936,
    qkv_bias=True, rope_theta=1e6, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="qwen2-smoke", family="dense",
    n_layers=2, d_model=56, n_heads=7, n_kv_heads=1, head_dim=8,
    d_ff=128, vocab_size=256,
    qkv_bias=True, rope_theta=1e6, tie_embeddings=True, attn_kv_chunk=16,
)
