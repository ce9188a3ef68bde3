"""mamba2-370m — SSD (state-space duality), attention-free [arXiv:2405.21060].

Assignment dims: 48L d_model=1024 (attn-free) d_ff=0 vocab=50280,
ssm_state=128.  Pure Mamba-2 blocks (mixer only, no FFN), expand=2,
head_dim=64 → 32 SSD heads.  Vocab padded 50280 → 50432.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=16, n_kv_heads=16,  # attn unused
    d_ff=0, vocab_size=50280, tie_embeddings=True,
    attn_every=-1,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_conv=4,
)

SMOKE_CONFIG = ModelConfig(
    name="mamba2-370m-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=512, tie_embeddings=True,
    attn_every=-1,
    ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_conv=4,
)
