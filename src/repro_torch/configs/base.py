"""Model/arch configuration system.

Every assigned architecture gets a module in this package exposing ``CONFIG``
(the exact published dims) and ``SMOKE_CONFIG`` (a reduced same-family config
for CPU smoke tests).  ``get_config(name)`` resolves either.
"""

from __future__ import annotations

import dataclasses
import importlib

VOCAB_PAD_MULTIPLE = 256


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 → d_model // n_heads
    qk_norm: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    moe_every: int = 1            # MoE FFN on layers where (idx % moe_every) == moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25
    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    attn_every: int = 0           # 0: all layers attention; n>0: attention iff idx % n == attn_offset; -1: no attention (pure SSM)
    attn_offset: int = 3
    # encoder-decoder
    n_encoder_layers: int = 0
    enc_seq: int = 1500
    # modality frontend stubs
    frontend: str = "none"        # none | vision_stub | audio_stub
    n_frontend_tokens: int = 0
    # attention partitioning/chunking
    q_head_pad_group: int = 0     # pad GQA group size to this (0 = no padding);
                                  # makes padded q-heads divisible by the model
                                  # axis when the real count is not (DESIGN.md)
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 1024
    # misc
    use_rope: bool = True          # False → learned absolute positions (whisper)
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"    # full | dots (save matmul outputs in bwd)
    # training
    max_seq_len: int = 8192

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def group_size(self) -> int:
        """Real GQA group size (q heads per kv head)."""
        return self.n_heads // self.n_kv_heads

    @property
    def padded_group_size(self) -> int:
        return max(self.q_head_pad_group, self.group_size)

    @property
    def padded_heads(self) -> int:
        """Q heads incl. group padding (layout: (kv_head, group) flattened)."""
        return self.n_kv_heads * self.padded_group_size

    @property
    def vocab_padded(self) -> int:
        m = VOCAB_PAD_MULTIPLE
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def is_encoder_decoder(self) -> bool:
        return self.family == "encdec"

    @property
    def experts_padded(self) -> int:
        """Experts padded to a multiple of 16 for clean EP on the model axis."""
        if self.n_experts == 0:
            return 0
        return ((self.n_experts + 15) // 16) * 16

    def layer_kind(self, idx: int) -> str:
        """"attn" or "ssm" mixer for decoder layer ``idx``."""
        if self.attn_every == -1:
            return "ssm"
        if self.attn_every == 0:
            return "attn"
        return "attn" if idx % self.attn_every == self.attn_offset else "ssm"

    def ffn_kind(self, idx: int) -> str:
        """"moe", "dense", or "none" FFN for decoder layer ``idx``."""
        if self.n_experts and idx % self.moe_every == self.moe_offset:
            return "moe"
        return "dense" if self.d_ff > 0 else "none"

    def param_count(self) -> int:
        """Total parameters (approximate analytic count; embeddings included)."""
        d, hd = self.d_model, self.resolved_head_dim
        n_q, n_kv = self.n_heads, self.n_kv_heads
        attn = d * hd * (n_q + 2 * n_kv) + n_q * hd * d
        dense_ffn = 3 * d * self.d_ff
        moe_ffn = self.n_experts * 3 * d * self.moe_d_ff + d * self.n_experts
        d_inner = self.ssm_expand * d
        n_ssm_heads = d_inner // self.ssm_head_dim
        ssm = (d * (2 * d_inner + 2 * self.ssm_state + n_ssm_heads)
               + d_inner * self.ssm_conv + d_inner * d + 2 * n_ssm_heads)
        total = self.vocab_padded * d  # embeddings
        if not self.tie_embeddings:
            total += self.vocab_padded * d
        layers = self.n_layers + self.n_encoder_layers
        for i in range(self.n_layers):
            total += attn if self.layer_kind(i) == "attn" else ssm
            total += moe_ffn if self.ffn_kind(i) == "moe" else dense_ffn
            total += 2 * d
        for _ in range(self.n_encoder_layers):  # encoder: attn + dense ffn (+cross in decoder, approx)
            total += attn + dense_ffn + 2 * d
        if self.is_encoder_decoder:  # cross attention in decoder layers
            total += self.n_layers * (attn + 2 * d)
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k experts instead of all)."""
        if not self.n_experts:
            return self.param_count()
        full_moe = self.n_experts * 3 * self.d_model * self.moe_d_ff
        act_moe = self.top_k * 3 * self.d_model * self.moe_d_ff
        n_moe_layers = sum(1 for i in range(self.n_layers)
                           if self.ffn_kind(i) == "moe")
        return int(self.param_count() - n_moe_layers * (full_moe - act_moe))


ARCH_NAMES = [
    "internvl2_76b", "smollm_135m", "qwen3_14b", "starcoder2_15b",
    "codeqwen15_7b", "granite_moe_3b", "qwen3_moe_30b", "whisper_small",
    "jamba_v01_52b", "mamba2_370m",
]

# external id (assignment spelling) -> module name
ARCH_IDS = {
    "internvl2-76b": "internvl2_76b",
    "smollm-135m": "smollm_135m",
    "qwen3-14b": "qwen3_14b",
    "starcoder2-15b": "starcoder2_15b",
    "codeqwen1.5-7b": "codeqwen15_7b",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b",
    "whisper-small": "whisper_small",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "mamba2-370m": "mamba2_370m",
}


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    mod_name = ARCH_IDS.get(name, name.replace("-", "_").replace(".", ""))
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG


# -- input shapes assigned to every architecture ------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# pure full-attention archs skip long_500k (assignment rule; DESIGN.md §7)
SUBQUADRATIC_ARCHS = {"jamba-v0.1-52b", "mamba2-370m"}


def cell_is_runnable(arch: str, shape: str) -> tuple[bool, str]:
    if shape == "long_500k" and arch not in SUBQUADRATIC_ARCHS:
        return False, "pure full-attention arch: long_500k needs sub-quadratic attention (skip per assignment)"
    return True, ""
