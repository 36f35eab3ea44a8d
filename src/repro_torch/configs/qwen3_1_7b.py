"""Assigned architecture config (see registry for the full pool)."""
from repro_torch.configs.base import ModelConfig

# [hf:Qwen/Qwen3-8B family] qk_norm, GQA kv=8, head_dim 128, tied embeddings.
CONFIG = ModelConfig(
    name="qwen3-1.7b", family="dense",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=8,
    d_ff=6144, vocab_size=151936, head_dim=128,
    qk_norm=True, tie_embeddings=True, rope_theta=1_000_000.0,
)

QWEN3_1_7B = CONFIG
