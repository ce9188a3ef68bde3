"""smollm-135m — llama-arch small [hf:HuggingFaceTB/SmolLM-135M].

Assignment dims: 30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152.
Also the ~100M end-to-end training example model (examples/train_lm.py).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m", family="dense",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, head_dim=64,
    d_ff=1536, vocab_size=49152, tie_embeddings=True,
    rope_theta=1e4,
)

SMOKE_CONFIG = ModelConfig(
    name="smollm-135m-smoke", family="dense",
    n_layers=2, d_model=48, n_heads=3, n_kv_heads=1, head_dim=16,
    d_ff=128, vocab_size=512, tie_embeddings=True,
)
