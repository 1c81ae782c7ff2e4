"""qwen1.5-110b [dense] — 80L d=8192 64H (GQA kv=8) d_ff=49152
vocab=152064, QKV bias.  The scale stressor: needs FSDP+TP(+grad
accumulation) to fit the dry-run HBM budget.
[hf:Qwen/Qwen1.5-110B; hf]"""
from .base import ModelConfig

FULL = ModelConfig(
    name="qwen1.5-110b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=49152, vocab_size=152064,
    qkv_bias=True, rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="qwen1.5-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=192, vocab_size=256,
    qkv_bias=True, rope_theta=1e6, attn_kv_chunk=16,
)
