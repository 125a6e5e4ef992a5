"""Architecture config: the port's own copy of `repro.configs.base.ArchConfig`.

Same fields, defaults and `reduced()` rule as the JAX package (the parity
tests compare the two field by field); only the configs this slice serves
are registered.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace

ARCH_IDS = ["yi_6b", "qwen2_0_5b"]


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | vlm | audio | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 => d_model // n_heads
    # attention
    attn_type: str = "gqa"            # gqa | mla | none
    qkv_bias: bool = False
    rope_theta: float = 1e4
    # MLA (deepseek-v2)
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # MLP
    mlp_type: str = "gated_silu"      # gated_silu | squared_relu | gelu
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_k_dense: int = 0
    moe_capacity_factor: float = 2.0
    moe_dropless: bool = False
    moe_group_size: int = 1024
    # SSM / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    attn_every: int = 0
    # enc-dec (whisper)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq_len: int = 0
    # modality frontend stub
    frontend: str = "none"
    frontend_tokens: int = 0
    # misc
    tie_embeddings: bool = False
    norm: str = "rmsnorm"
    supports_long_context: bool = False
    max_seq_len: int = 0
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def vec_pos_decode(self) -> bool:
        """Decode takes a per-slot (B,) position vector (continuous
        batching): the transformer families whose cache is indexed by
        absolute position."""
        return self.family in ("dense", "moe", "vlm")

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    def reduced(self) -> "ArchConfig":
        """Same family/code paths, CPU-sized."""
        r = {
            "name": self.name + "_reduced",
            "n_layers": min(self.n_layers, 4 if self.attn_every == 0 else 2 * max(self.attn_every, 1)),
            "d_model": 64,
            "n_heads": 4,
            "n_kv_heads": min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            "head_dim": 16,
            "d_ff": 128,
            "vocab_size": 256,
            "encoder_seq_len": min(self.encoder_seq_len, 32) if self.encoder_seq_len else 0,
            "frontend_tokens": min(self.frontend_tokens, 16) if self.frontend_tokens else 0,
            "max_seq_len": 0,
        }
        if self.n_experts:
            r.update(n_experts=8, top_k=2, moe_d_ff=32,
                     n_shared_experts=min(self.n_shared_experts, 1),
                     first_k_dense=min(self.first_k_dense, 1))
        if self.attn_type == "mla":
            r.update(kv_lora_rank=32, q_lora_rank=32,
                     qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16)
        if self.ssm_state:
            r.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
        if self.attn_every:
            r.update(attn_every=2)
        if self.n_encoder_layers:
            r.update(n_encoder_layers=2)
        return replace(self, **r)


def get_config(arch_id: str) -> ArchConfig:
    arch_id = arch_id.replace("-", "_")
    if arch_id not in ARCH_IDS:
        raise NotImplementedError(
            f"arch {arch_id!r}: later slice (this slice ports {ARCH_IDS})")
    return importlib.import_module(f"repro_torch.configs.{arch_id}").CONFIG
