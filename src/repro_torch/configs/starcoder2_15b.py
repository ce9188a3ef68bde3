"""starcoder2-15b — GQA, RoPE [arXiv:2402.19173].

Assignment dims: 40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4, head_dim=128,
    d_ff=24576, vocab_size=49152,
    rope_theta=1e5,
)

SMOKE_CONFIG = ModelConfig(
    name="starcoder2-15b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=256, vocab_size=512,
)
