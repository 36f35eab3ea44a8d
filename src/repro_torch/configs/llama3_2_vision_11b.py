"""Assigned architecture config (see registry for the full pool)."""
from repro_torch.configs.base import ModelConfig

# [hf:meta-llama/Llama-3.2-11B-Vision] cross-attn image layers every 5th layer.
CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=128256, head_dim=128,
    cross_attn_every=5, num_image_tokens=1601,
    rope_theta=500_000.0, scan_layers=False,
)

LLAMA3_2_VISION_11B = CONFIG
