"""internvl2-76b — InternViT + InternLM2 backbone [arXiv:2404.16821].

Assignment dims: 80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
VLM: the ViT frontend is a STUB — ``input_specs`` provides precomputed patch
embeddings (n_frontend_tokens × d_model) which overwrite the first positions
of the token embedding sequence.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=128256,
    frontend="vision_stub", n_frontend_tokens=256,
    rope_theta=1e6,
)

SMOKE_CONFIG = ModelConfig(
    name="internvl2-76b-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512,
    frontend="vision_stub", n_frontend_tokens=8,
)
