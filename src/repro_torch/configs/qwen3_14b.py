"""qwen3-14b — qk_norm, GQA [hf:Qwen/Qwen3-8B family].

Assignment dims: 40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936.
Note: 40 q-heads / 8 kv-heads do not divide the 16-way model axis evenly;
head sharding is GSPMD-padded (roofline impact discussed in EXPERIMENTS.md).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=17408, vocab_size=151936, qk_norm=True,
    rope_theta=1e6,
    # 40 q heads don't divide the 16-way model axis: pad GQA groups 5→6
    # (48 padded heads, masked) so attention TP-shards cleanly.
    q_head_pad_group=6,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen3-14b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=5, n_kv_heads=1, head_dim=16,
    d_ff=160, vocab_size=512, qk_norm=True,
)
