"""qwen3-moe-30b-a3b — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B].

Assignment dims: 48L d_model=2048 32H (GQA kv=4) d_ff=768 (per expert)
vocab=151936, MoE 128e top-8 every layer.  head_dim=128 per the published
model (q projection 2048 → 4096).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=768, vocab_size=151936, qk_norm=True,
    n_experts=128, top_k=8, moe_d_ff=768, moe_every=1,
    rope_theta=1e6,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=64, vocab_size=512, qk_norm=True,
    n_experts=8, top_k=2, moe_d_ff=64, moe_every=1,
)
