"""Assigned architecture config (see registry for the full pool)."""
from repro_torch.configs.base import ModelConfig

# [arXiv:2411.15242] Mamba2 backbone + shared attention block every 6 layers.
CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32000, head_dim=64,
    ssm_state=64, ssm_conv=4, ssm_expand=2, ssm_head_dim=64,
    hybrid_attn_every=6, scan_layers=False, tie_embeddings=True,
)

ZAMBA2_1_2B = CONFIG
