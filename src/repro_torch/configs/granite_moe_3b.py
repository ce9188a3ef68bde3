"""granite-moe-3b-a800m — IBM granite MoE [hf:ibm-granite family].

Assignment dims: 32L d_model=1536 24H (GQA kv=8) d_ff=512 (per expert)
vocab=49155, MoE 40 experts top-8, every layer.
40 experts are EP-padded to 48 on the 16-way model axis (3/device).
Vocab 49155 is padded to 49408 (multiple of 256) for clean vocab TP.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49155,
    n_experts=40, top_k=8, moe_d_ff=512, moe_every=1,
    rope_theta=1e4,
    # 24 q heads don't divide the model axis: pad GQA groups 3→4 (32 heads).
    q_head_pad_group=4,
)

SMOKE_CONFIG = ModelConfig(
    name="granite-moe-3b-a800m-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=64, vocab_size=515,
    n_experts=8, top_k=2, moe_d_ff=64, moe_every=1,
)
