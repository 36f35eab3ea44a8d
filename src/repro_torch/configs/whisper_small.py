"""Assigned architecture config (see registry for the full pool)."""
from repro_torch.configs.base import ModelConfig

# [arXiv:2212.04356] enc-dec; conv frontend is a STUB (precomputed frame embeds).
CONFIG = ModelConfig(
    name="whisper-small", family="audio",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
    d_ff=3072, vocab_size=51865, head_dim=64,
    norm_type="layernorm", mlp_type="gelu", use_rope=False,
    encoder_layers=12, encoder_frames=1500, is_encoder_decoder=True,
    scan_layers=False,
)

WHISPER_SMALL = CONFIG
