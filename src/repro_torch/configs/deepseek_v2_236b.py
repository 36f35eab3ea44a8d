"""Assigned architecture config (see registry for the full pool)."""
from repro_torch.configs.base import ModelConfig

# [arXiv:2405.04434] MLA kv_lora=512, 2 shared + 160 routed top-6, first layer dense.
CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    num_layers=60, d_model=5120, num_heads=128, num_kv_heads=128,
    d_ff=12288, vocab_size=102400,
    attn_type="mla", q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    num_experts=160, num_experts_per_tok=6, num_shared_experts=2,
    moe_d_ff=1536, first_k_dense=1, rope_theta=10_000.0,
    moe_group_size=8192, optimizer="adafactor",
)

DEEPSEEK_V2_236B = CONFIG
