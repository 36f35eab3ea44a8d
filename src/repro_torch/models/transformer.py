"""Block assembly and the full LM forward, prefill and decode, dense family
(the counterpart of the reference's ``models/transformer.py``).

Layer parameters are stacked ``(L, ...)`` as in the reference, so its
parameter tree carries over as it is; the reference's ``lax.scan`` over the
stack is a Python loop over layers here (``cfg.scan_layers`` has no
effect). ``params`` are the parameters in the compute dtype, as
``Model`` hands them over (norm scales stay in float32). The moe, ssm and
hybrid families wait for their slices of the port.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models.params import stack_tree


def _dense_only(cfg: ModelConfig):
    if cfg.attn_type == "mla":
        attn._not_ported("MLA attention", "deepseek-v2")
    if cfg.family != "dense":
        slice_name = {"moe": "mixtral (MoE)", "ssm": "mamba2 (SSM)",
                      "hybrid": "zamba2 (hybrid)"}.get(
                          cfg.family, "multimodal")
        attn._not_ported(f"the {cfg.family} family", slice_name)


def zero_aux(device=None):
    return {"moe_aux": torch.zeros((), device=device),
            "moe_z": torch.zeros((), device=device)}


def layer(stack, i: int):
    """Layer ``i`` of a stacked parameter (or cache) tree, as views."""
    if isinstance(stack, dict):
        return {k: layer(v, i) for k, v in stack.items()}
    return stack[i]


# =============================================================================
# single blocks
# =============================================================================

def attn_block_params(cfg: ModelConfig, d_ff=None):
    return {
        "ln1": L.norm_params(cfg),
        "ln2": L.norm_params(cfg),
        "attn": attn.gqa_params(cfg),
        "mlp": L.mlp_params(cfg, d_ff=d_ff),
    }


def attn_block_apply(p, x, cfg, positions=None, collect_kv=False):
    h = L.norm_apply(p["ln1"], x, cfg)
    a, kv = attn.gqa_apply(p["attn"], h, cfg, positions)
    x = x + a
    h = L.norm_apply(p["ln2"], x, cfg)
    x = x + L.mlp_apply(p["mlp"], h, cfg)
    return (x, kv) if collect_kv else x


def attn_block_decode(p, x, cache, pos, cfg, n_valid=None, block_table=None):
    h = L.norm_apply(p["ln1"], x, cfg)
    a, cache = attn.gqa_decode(p["attn"], h, cache, pos, cfg,
                               n_valid=n_valid, block_table=block_table)
    x = x + a
    h = L.norm_apply(p["ln2"], x, cfg)
    return x + L.mlp_apply(p["mlp"], h, cfg), cache


# =============================================================================
# top-level model params
# =============================================================================

def _uniform_stack_params(cfg: ModelConfig):
    _dense_only(cfg)
    one = attn_block_params(cfg)
    return {"stack": stack_tree(one, cfg.num_layers)}, cfg.num_layers


def lm_params(cfg: ModelConfig):
    blocks, _ = _uniform_stack_params(cfg)
    return {"embed": L.embed_params(cfg), "final_ln": L.norm_params(cfg),
            "blocks": blocks}


def _n_layers(params) -> int:
    return params["blocks"]["stack"]["ln1"]["scale"].shape[0]


# =============================================================================
# forward, prefill, decode
# =============================================================================

def lm_apply(params, tokens, cfg: ModelConfig):
    """tokens (B,S) -> (logits (B,S,V), aux)."""
    _dense_only(cfg)
    x = L.embed_apply(params["embed"], tokens, cfg)
    st = params["blocks"]["stack"]
    for i in range(_n_layers(params)):
        x = attn_block_apply(layer(st, i), x, cfg)
    x = L.norm_apply(params["final_ln"], x, cfg)
    return L.unembed_apply(params["embed"], x, cfg), zero_aux(x.device)


def lm_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
             device=None):
    """Zero decode cache for the whole stack: every leaf gets a leading
    layer axis, ``{"stack": {"k", "v": (L, B, T, Hkv, D), "pos_ids":
    (L, B, T)}}``."""
    _dense_only(cfg)
    one = attn.gqa_cache_init(cfg, batch, max_len, dtype, device)
    return {"stack": {k: v[None].repeat(cfg.num_layers, *([1] * v.dim()))
                      for k, v in one.items()}}


def lm_prefill(params, tokens, cfg: ModelConfig,
               max_len: Optional[int] = None, lengths=None):
    """tokens (B,S) -> (logits, seeded cache with capacity max_len or S).

    ``lengths`` (B,) marks per-row true prompt lengths when the batch is
    right-padded: cache positions past a row's length record
    ``pos_id = -1``."""
    _dense_only(cfg)
    B, S = tokens.shape
    max_len = max_len or S
    x = L.embed_apply(params["embed"], tokens, cfg)
    cache: Dict[str, Any] = lm_cache(cfg, B, max_len, L.cdt(cfg), x.device)
    st = params["blocks"]["stack"]
    for i in range(_n_layers(params)):
        x, kv = attn_block_apply(layer(st, i), x, cfg, collect_kv=True)
        attn.gqa_seed_cache(layer(cache["stack"], i), kv, S, lengths=lengths)
    x = L.norm_apply(params["final_ln"], x, cfg)
    return L.unembed_apply(params["embed"], x, cfg), cache


def lm_decode(params, tokens, cache, pos, cfg: ModelConfig, n_valid=None,
              block_table=None):
    """tokens (B,S) -> logits (B,S,V); the cache is updated in place (and
    returned). ``pos`` is a scalar or a (B,) vector of per-slot positions,
    S may exceed 1 (a chunked-prefill extend); ``n_valid`` (B,) marks real
    tokens per row. With ``block_table`` (B, n_pages) int32 the cache is the
    serving tier's page pool (``lm_cache(cfg, pages, page_size, ...)``)."""
    _dense_only(cfg)
    x = L.embed_apply(params["embed"], tokens, cfg)
    st = params["blocks"]["stack"]
    for i in range(_n_layers(params)):
        x, _ = attn_block_decode(layer(st, i), x, layer(cache["stack"], i),
                                 pos, cfg, n_valid=n_valid,
                                 block_table=block_table)
    x = L.norm_apply(params["final_ln"], x, cfg)
    return L.unembed_apply(params["embed"], x, cfg), cache
