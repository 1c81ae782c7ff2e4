"""llama4-scout-17b-16e [moe] — 48L d=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 routed experts top-1 + 1 shared expert.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from .base import ModelConfig, MoEConfig

FULL = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=202048,
    rope_theta=5e5,
    moe=MoEConfig(n_experts=16, top_k=1, d_expert_ff=8192, n_shared=1),
)

SMOKE = ModelConfig(
    name="llama4-scout-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, rope_theta=5e5,
    moe=MoEConfig(n_experts=4, top_k=1, d_expert_ff=128, n_shared=1),
    attn_kv_chunk=32,
)
