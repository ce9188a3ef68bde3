"""jamba-v0.1-52b — Mamba+attention 1:7 interleave, MoE 16e top-2 [arXiv:2403.19887].

Assignment dims: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536,
MoE 16 experts top-2.  Layer pattern per the paper: within each 8-layer block,
layer 3 (0-based) is attention, the rest are Mamba; MoE replaces the dense FFN
on every second layer (odd indices).

Adaptation note (DESIGN.md §7): the published Jamba uses Mamba-1 selective-scan
mixers (d_state 16); this framework implements the Mamba-2 SSD mixer and reuses
it here with ssm_state=16 — same asymptotics, TPU-friendlier chunked form.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=65536,
    n_experts=16, top_k=2, moe_d_ff=14336, moe_every=2, moe_offset=1,
    attn_every=8, attn_offset=3,
    ssm_state=16, ssm_head_dim=64, ssm_expand=2, ssm_conv=4,
    rope_theta=1e6,
)

SMOKE_CONFIG = ModelConfig(
    name="jamba-v0.1-52b-smoke", family="hybrid",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512,
    n_experts=4, top_k=2, moe_d_ff=128, moe_every=2, moe_offset=1,
    attn_every=4, attn_offset=3,
    ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_conv=4,
)
