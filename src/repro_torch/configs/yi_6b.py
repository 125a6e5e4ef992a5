"""Yi-6B (llama-arch GQA) [arXiv:2403.04652; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="yi_6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64000,
    attn_type="gqa",
    mlp_type="gated_silu",
    rope_theta=5e6,
    source="arXiv:2403.04652; hf:01-ai/Yi-6B",
)
