"""whisper-small — encoder-decoder audio backbone [arXiv:2212.04356].

Assignment dims: 12L d_model=768 12H (kv=12) d_ff=3072 vocab=51865.
Enc-dec: 12 encoder + 12 decoder layers.  The conv/log-mel frontend is a STUB —
``input_specs`` provides precomputed frame embeddings (enc_seq × d_model).
Positions are learned-absolute (no RoPE), as in the published model.
Vocab padded 51865 → 52224 for vocab TP.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="encdec",
    n_layers=12, n_encoder_layers=12,
    d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
    d_ff=3072, vocab_size=51865,
    frontend="audio_stub", enc_seq=1500, use_rope=False,
    max_seq_len=32768,  # learned decoder positions must cover the 32k shapes
)

SMOKE_CONFIG = ModelConfig(
    name="whisper-small-smoke", family="encdec",
    n_layers=2, n_encoder_layers=2,
    d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512,
    frontend="audio_stub", enc_seq=32, use_rope=False,
)
