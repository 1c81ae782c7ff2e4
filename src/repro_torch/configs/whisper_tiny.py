"""whisper-tiny [audio] — enc-dec, 4+4L d=384 6H (MHA) d_ff=1536
vocab=51865; conv/mel frontend is a stub (precomputed frame
embeddings, 1500 frames).  [arXiv:2212.04356; unverified]"""
from .base import ModelConfig

FULL = ModelConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6, head_dim=64,
    d_ff=1536, vocab_size=51865,
    is_encoder_decoder=True, n_encoder_layers=4, n_frames=1500,
    rope_kind="none", mlp_kind="gelu", norm_kind="layernorm",
    norm_eps=1e-5, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256,
    is_encoder_decoder=True, n_encoder_layers=2, n_frames=32,
    rope_kind="none", mlp_kind="gelu", norm_kind="layernorm",
    norm_eps=1e-5, tie_embeddings=True, attn_kv_chunk=16,
)
