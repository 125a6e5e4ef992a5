"""Qwen2-0.5B (GQA, QKV bias, tied embeddings) [arXiv:2407.10671; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2_0_5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151936,
    attn_type="gqa",
    qkv_bias=True,
    mlp_type="gated_silu",
    tie_embeddings=True,
    rope_theta=1e6,
    source="arXiv:2407.10671; hf:Qwen/Qwen2-0.5B",
)
