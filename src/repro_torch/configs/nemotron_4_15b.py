"""Assigned architecture config (see registry for the full pool)."""
from repro_torch.configs.base import ModelConfig

# [arXiv:2402.16819] GQA kv=8, squared-ReLU MLP (no gate), rope.
CONFIG = ModelConfig(
    name="nemotron-4-15b", family="dense",
    num_layers=32, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=24576, vocab_size=256000, head_dim=128,
    mlp_type="relu2", rope_theta=10_000.0,
)

NEMOTRON_4_15B = CONFIG
