"""Config system: architecture configs and input-shape specs.

Every assigned architecture gets one ``<arch>.py`` module exporting ``CONFIG``.
``registry.get(name)`` returns the full-size config; ``cfg.reduced()`` returns a
CPU-smoke-test-sized config of the same family (same code paths, tiny dims).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Input shapes (assigned): every LM arch is paired with these four shapes.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# Archs with O(L^2) full attention skip long_500k (see DESIGN.md §6).
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description. One instance per assigned architecture."""

    name: str
    family: str  # dense | ssm | moe | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- norms / activations -------------------------------------------------
    mlp_type: str = "swiglu"  # swiglu | relu2 | gelu
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-5
    qk_norm: bool = False
    rope_theta: float = 500_000.0
    use_rope: bool = True
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    # --- attention extras ----------------------------------------------------
    attn_type: str = "gqa"  # gqa | mla
    sliding_window: int = 0  # 0 = full attention
    # MLA (deepseek-v2)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- MoE ------------------------------------------------------------------
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0  # per-expert hidden
    first_k_dense: int = 0  # leading dense layers in an MoE stack
    moe_capacity_factor: float = 1.25
    router_aux_coef: float = 0.001
    router_z_coef: float = 0.001

    # --- SSM (mamba2) -----------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_ngroups: int = 1
    ssm_chunk: int = 256
    hybrid_attn_every: int = 0  # zamba2: shared attn block after every k ssm layers

    # --- multimodal -----------------------------------------------------------
    cross_attn_every: int = 0  # vlm: cross-attn layer every k layers
    num_image_tokens: int = 0
    encoder_layers: int = 0  # whisper
    encoder_frames: int = 0
    is_encoder_decoder: bool = False

    # --- infra ------------------------------------------------------------
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    scan_layers: bool = True
    remat: str = "full"  # none | full
    max_seq_len: int = 524_288
    optimizer: str = "adamw"  # adamw | adafactor
    moe_group_size: int = 0  # tokens per dispatch group; 0 = single group

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_head_dim else 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests (one fwd/train step)."""
        kw = dict(
            name=self.name + "-smoke",
            num_layers=min(self.num_layers, 2 if not self.hybrid_attn_every else 4),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads < self.num_heads else 4,
            d_ff=128,
            vocab_size=256,
            head_dim=16,
            max_seq_len=256,
            scan_layers=self.scan_layers,
            remat="none",
        )
        if self.attn_type == "mla":
            kw.update(q_lora_rank=32, kv_lora_rank=32, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16, head_dim=0)
        if self.is_moe:
            kw.update(num_experts=min(self.num_experts, 8),
                      num_experts_per_tok=min(self.num_experts_per_tok, 2),
                      moe_d_ff=64,
                      num_shared_experts=self.num_shared_experts and 1,
                      first_k_dense=min(self.first_k_dense, 1))
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=32)
        if self.hybrid_attn_every:
            kw.update(hybrid_attn_every=2)
        if self.cross_attn_every:
            kw.update(cross_attn_every=2, num_image_tokens=16)
        if self.encoder_layers:
            kw.update(encoder_layers=2, encoder_frames=32)
        return self.replace(**kw)

    def shapes(self) -> Tuple[str, ...]:
        """Shape names applicable to this arch (long_500k only if sub-quadratic)."""
        names = ["train_4k", "prefill_32k", "decode_32k"]
        if self.family in SUBQUADRATIC_FAMILIES:
            names.append("long_500k")
        return tuple(names)


def pad_to_multiple(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
