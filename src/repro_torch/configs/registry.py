"""Architecture registry: the 10 assigned architectures.

Each architecture lives in its own ``configs/<id>.py`` module
(exact parameters from the assignment sheet, sources noted inline); this
module aggregates them and exposes lookup helpers.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, SHAPES, ShapeSpec
from repro_torch.configs.nemotron_4_15b import CONFIG as NEMOTRON_4_15B
from repro_torch.configs.qwen3_1_7b import CONFIG as QWEN3_1_7B
from repro_torch.configs.llama3_2_1b import CONFIG as LLAMA3_2_1B
from repro_torch.configs.deepseek_67b import CONFIG as DEEPSEEK_67B
from repro_torch.configs.mamba2_780m import CONFIG as MAMBA2_780M
from repro_torch.configs.deepseek_v2_236b import CONFIG as DEEPSEEK_V2_236B
from repro_torch.configs.mixtral_8x7b import CONFIG as MIXTRAL_8X7B
from repro_torch.configs.zamba2_1_2b import CONFIG as ZAMBA2_1_2B
from repro_torch.configs.llama3_2_vision_11b import CONFIG as LLAMA3_2_VISION_11B
from repro_torch.configs.whisper_small import CONFIG as WHISPER_SMALL

ARCHS = {
    c.name: c
    for c in [
        NEMOTRON_4_15B, QWEN3_1_7B, LLAMA3_2_1B, DEEPSEEK_67B, MAMBA2_780M,
        DEEPSEEK_V2_236B, MIXTRAL_8X7B, ZAMBA2_1_2B, LLAMA3_2_VISION_11B,
        WHISPER_SMALL,
    ]
}


def get(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeSpec:
    return SHAPES[name]


def all_cells():
    """Every (arch, shape) dry-run cell, honouring per-family shape skips."""
    for arch in ARCHS.values():
        for shape in arch.shapes():
            yield arch.name, shape
