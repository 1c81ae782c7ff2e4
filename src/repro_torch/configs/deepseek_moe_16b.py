"""deepseek-moe-16b [moe] — 28L d=2048 16H (MHA kv=16) per-expert
d_ff=1408, vocab=102400; 2 shared + 64 routed top-6, fine-grained
experts; first layer is a dense FFN.  [arXiv:2401.06066; hf]"""
from .base import ModelConfig, MoEConfig

FULL = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=102400,
    moe=MoEConfig(n_experts=64, top_k=6, d_expert_ff=1408, n_shared=2,
                  first_dense=1, dense_d_ff=10944),
)

SMOKE = ModelConfig(
    name="deepseek-moe-smoke", family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=48, vocab_size=256,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert_ff=48, n_shared=2,
                  first_dense=1, dense_d_ff=96),
    attn_kv_chunk=32,
)
