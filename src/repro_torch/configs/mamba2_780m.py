"""Assigned architecture config (see registry for the full pool)."""
from repro_torch.configs.base import ModelConfig

# [arXiv:2405.21060] Mamba2 SSD, attention-free.
CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    num_layers=48, d_model=1536, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_conv=4, ssm_expand=2, ssm_head_dim=64,
    use_rope=False, tie_embeddings=True,
)

MAMBA2_780M = CONFIG
