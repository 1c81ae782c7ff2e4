"""rwkv6-3b [ssm] — Finch, 32L d=2560 (attention-free, 40 heads of 64)
d_ff=8960 vocab=65536; data-dependent decay WKV.  O(1) state ->
eligible for long_500k.  [arXiv:2404.05892; hf]"""
from .base import ModelConfig

FULL = ModelConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, head_dim=64,
    d_ff=8960, vocab_size=65536,
    block_pattern=("rwkv",), rope_kind="none",
    norm_kind="layernorm", norm_eps=1e-5,
    sub_quadratic=True,
)

SMOKE = ModelConfig(
    name="rwkv6-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256,
    block_pattern=("rwkv",), rope_kind="none",
    norm_kind="layernorm", norm_eps=1e-5,
    sub_quadratic=True,
)
