"""Assigned architecture config (see registry for the full pool)."""
from repro_torch.configs.base import ModelConfig

# [arXiv:2401.04088] 8 experts top-2, sliding-window attention.
CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=32000, head_dim=128,
    num_experts=8, num_experts_per_tok=2, moe_d_ff=14336,
    sliding_window=4096, rope_theta=1_000_000.0,
    moe_group_size=16384,
)

MIXTRAL_8X7B = CONFIG
