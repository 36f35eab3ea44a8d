"""Assigned architecture config (see registry for the full pool)."""
from repro_torch.configs.base import ModelConfig

# [arXiv:2401.02954] llama-arch, 95L.
CONFIG = ModelConfig(
    name="deepseek-67b", family="dense",
    num_layers=95, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=22016, vocab_size=102400, head_dim=128,
    rope_theta=10_000.0, optimizer="adafactor",
)

DEEPSEEK_67B = CONFIG
