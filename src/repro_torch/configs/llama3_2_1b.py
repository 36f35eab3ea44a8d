"""Assigned architecture config (see registry for the full pool)."""
from repro_torch.configs.base import ModelConfig

# [hf:meta-llama/Llama-3.2-1B] small llama3.
CONFIG = ModelConfig(
    name="llama3.2-1b", family="dense",
    num_layers=16, d_model=2048, num_heads=32, num_kv_heads=8,
    d_ff=8192, vocab_size=128256, head_dim=64,
    tie_embeddings=True, rope_theta=500_000.0,
)

LLAMA3_2_1B = CONFIG
