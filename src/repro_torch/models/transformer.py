"""Block assembly and the full LM forward, prefill and decode for the dense,
moe, ssm and hybrid families (the counterpart of the reference's
``models/transformer.py``).

Layer parameters are stacked ``(L, ...)`` as in the reference, so its
parameter tree carries over as it is; the reference's ``lax.scan`` over the
stack is a Python loop over layers here (``cfg.scan_layers`` has no
effect). The hybrid stack (zamba2) is the reference's groups: ``(n_groups,
k, ...)`` stacked mamba layers, each group followed by the one weight-shared
attention block, then a ``tail`` of the ``num_layers % k`` leftover mamba
layers (``{}`` when there are none). The moe stack (mixtral) is the
reference's too: ``first_k_dense`` leading dense blocks under ``dense{i}``,
then the stacked MoE blocks, whose ``moe_aux`` and ``moe_z`` sum over the
stack as the reference's scan sums them. With ``attn_type == "mla"``
(deepseek-v2) every attention block is MLA (``attention.mla_*``) and its
cache the compressed rows. ``params`` are the parameters in the compute
dtype, as ``Model`` hands them over (norm scales stay in float32). The
multimodal families (vlm, audio) are assembled in ``models/multimodal.py``
from the blocks here.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.params import stack_tree, tree_leaves, tree_map
from repro_torch.sharding.plan import Spec

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def check_supported(cfg: ModelConfig):
    """Raise for a family that neither the port nor the reference knows
    (the reference's ``lm_cache`` raises ``ValueError(family)``)."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r}; the port "
                         f"runs {FAMILIES}")


def _mla(cfg: ModelConfig) -> bool:
    return cfg.attn_type == "mla"


def run_block(fn, cfg: ModelConfig, *args, **kw):
    """``fn(*args, **kw)``, one block of a forward. Where autograd records
    and ``cfg.remat == "full"`` the block runs under activation
    checkpointing (``torch.utils.checkpoint``, non-reentrant): its
    activations are recomputed in the backward, as the reference's
    ``_maybe_remat`` wraps its block bodies in ``jax.checkpoint``, so a
    kernel in it launches twice a training step. Serving runs without
    autograd and is not touched."""
    if cfg.remat == "full" and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False, **kw)
    return fn(*args, **kw)


def zero_aux(device=None):
    return {"moe_aux": torch.zeros((), device=device),
            "moe_z": torch.zeros((), device=device)}


def layer(stack, i: int):
    """Layer ``i`` of a stacked parameter (or cache) tree, as views."""
    if isinstance(stack, dict):
        return {k: layer(v, i) for k, v in stack.items()}
    return stack[i]


def depth(stack) -> int:
    """The leading (stacked-layers) extent of a tree; 0 for ``{}``."""
    leaves = tree_leaves(stack)
    return leaves[0].shape[0] if leaves else 0


def _stack(trees):
    """A list of equal trees as one tree with a new leading axis."""
    return {k: _stack([t[k] for t in trees]) if isinstance(v, dict)
            else torch.stack([t[k] for t in trees])
            for k, v in trees[0].items()}


# =============================================================================
# single blocks
# =============================================================================

def attn_block_params(cfg: ModelConfig, use_moe: bool = False, d_ff=None,
                      *, plan):
    p = {
        "ln1": L.norm_params(cfg),
        "ln2": L.norm_params(cfg),
        "attn": (attn.mla_params(cfg, plan) if _mla(cfg)
                 else attn.gqa_params(cfg, plan=plan)),
    }
    if use_moe:
        p["moe"] = moe_lib.moe_params(cfg)
    else:
        p["mlp"] = L.mlp_params(cfg, d_ff=d_ff)
    return p


def _ffn(p, h, cfg, cols=False):
    """The block's MLP or MoE layer: (out, {moe_aux, moe_z})."""
    if "moe" in p:
        return moe_lib.moe_apply(p["moe"], h, cfg, cols)
    return L.mlp_apply(p["mlp"], h, cfg, cols), zero_aux(h.device)


def attn_block_apply(p, x, cfg, positions=None, collect_kv=False):
    """-> (x, aux), or (x, aux, (k, v)) with ``collect_kv``."""
    h = L.norm_apply(p["ln1"], x, cfg)
    if _mla(cfg):
        a, kv = attn.mla_apply(p["attn"], h, cfg, positions)
    else:
        a, kv = attn.gqa_apply(p["attn"], h, cfg, positions)
    x = x + a
    m, aux = _ffn(p, L.norm_apply(p["ln2"], x, cfg), cfg)
    x = x + m
    return (x, aux, kv) if collect_kv else (x, aux)


def attn_block_decode(p, x, cache, pos, cfg, n_valid=None, block_table=None,
                      scratch_table=None, null_page=None, idle_slots=None,
                      cols=False):
    """``cols``: the ops whose rounding depends on the row count a column
    at a time (``L.by_column``)."""
    h = L.tap("ln1", L.norm_apply(p["ln1"], x, cfg, cols))
    if _mla(cfg):
        a, cache = attn.mla_decode(p["attn"], h, cache, pos, cfg,
                                   n_valid=n_valid, block_table=block_table,
                                   null_page=null_page, cols=cols)
    else:
        a, cache = attn.gqa_decode(p["attn"], h, cache, pos, cfg,
                                   n_valid=n_valid, block_table=block_table,
                                   scratch_table=scratch_table,
                                   null_page=null_page,
                                   idle_slots=idle_slots, cols=cols)
    x = x + a
    h = L.tap("ln2", L.norm_apply(p["ln2"], x, cfg, cols))
    return x + _ffn(p, h, cfg, cols)[0], cache


def ssm_block_params(cfg: ModelConfig):
    return {"ln": L.norm_params(cfg), "ssm": ssm_lib.ssm_params(cfg)}


def ssm_block_apply(p, x, cfg):
    h = L.norm_apply(p["ln"], x, cfg)
    o, state = ssm_lib.ssm_apply(p["ssm"], h, cfg)
    return x + o, state


def ssm_block_decode(p, x, state, cfg):
    h = L.norm_apply(p["ln"], x, cfg)
    o, state = ssm_lib.ssm_decode(p["ssm"], h, state, cfg)
    return x + o, state


def _ssm_stack_apply(stack, x, cfg, states=None):
    """Run the stacked mamba layers; with a list ``states``, append each
    layer's final state (the prefill's decode seed) to it."""
    for i in range(depth(stack)):
        x, st = run_block(ssm_block_apply, cfg, layer(stack, i), x, cfg)
        if states is not None:
            states.append(st)
    return x


def _ssm_stack_decode(stack, x, cache, cfg):
    for i in range(depth(stack)):
        x, _ = ssm_block_decode(layer(stack, i), x, layer(cache, i), cfg)
    return x


# =============================================================================
# top-level model params
# =============================================================================

def _n_dense(cfg: ModelConfig) -> int:
    """Leading dense blocks of an MoE stack (``dense{i}``)."""
    return cfg.first_k_dense if cfg.is_moe else 0


def _blocks(tree, cfg: ModelConfig):
    """The per-layer trees of an attention stack (parameters or cache) in
    order: the ``dense{i}`` blocks, then the stacked layers."""
    return ([tree[f"dense{i}"] for i in range(_n_dense(cfg))]
            + [layer(tree["stack"], i) for i in range(depth(tree["stack"]))])


def attn_cache(cfg: ModelConfig, plan, batch: int, max_len: int, dtype,
               device=None):
    """One attention block's zero decode cache: MLA's compressed rows, or
    GQA's K/V (a ring for a sliding window) with the plan's KV heads."""
    if _mla(cfg):
        return attn.mla_cache_init(cfg, batch, max_len, dtype, device)
    return attn.gqa_cache_init(cfg, batch, max_len, dtype, device, plan=plan)


def seed_attn_cache(cfg: ModelConfig, cache, kv, lengths=None):
    """Write one attention block's prefill K/V (MLA: c_kv, k_rope) into its
    zero decode cache, in place."""
    seed = attn.mla_seed_cache if _mla(cfg) else attn.gqa_seed_cache
    return seed(cache, kv, kv[0].shape[1], lengths=lengths)


def lm_params(cfg: ModelConfig, plan):
    check_supported(cfg)
    p: Dict[str, Any] = {"embed": L.embed_params(cfg, plan),
                         "final_ln": L.norm_params(cfg)}
    if cfg.family == "hybrid":
        k = cfg.hybrid_attn_every
        n_groups, rem = divmod(cfg.num_layers, k)
        p["blocks"] = {
            "groups": stack_tree(stack_tree(ssm_block_params(cfg), k),
                                 n_groups),
            "shared_attn": attn_block_params(cfg, plan=plan),
            "tail": (stack_tree(ssm_block_params(cfg), rem) if rem
                     else {}),
        }
    elif cfg.family == "ssm":
        p["blocks"] = {"stack": stack_tree(ssm_block_params(cfg),
                                           cfg.num_layers)}
    else:
        n_dense = _n_dense(cfg)
        p["blocks"] = {
            "stack": stack_tree(attn_block_params(cfg, use_moe=cfg.is_moe,
                                                  plan=plan),
                                cfg.num_layers - n_dense),
            **{f"dense{i}": attn_block_params(cfg, plan=plan)
               for i in range(n_dense)}}
    return p


# =============================================================================
# forward, prefill, decode
# =============================================================================

def _hybrid_apply(bp, x, cfg):
    for g in range(depth(bp["groups"])):
        x = _ssm_stack_apply(layer(bp["groups"], g), x, cfg)
        x, _ = run_block(attn_block_apply, cfg, bp["shared_attn"], x, cfg)
    return _ssm_stack_apply(bp["tail"], x, cfg)


def lm_apply(params, tokens, cfg: ModelConfig):
    """tokens (B,S) -> (logits (B,S,V), aux): ``moe_aux`` and ``moe_z``
    summed over the stacked layers (zeros without MoE)."""
    check_supported(cfg)
    x = L.embed_apply(params["embed"], tokens, cfg)
    bp = params["blocks"]
    aux = zero_aux(x.device)
    if cfg.family == "hybrid":
        x = _hybrid_apply(bp, x, cfg)
    elif cfg.family == "ssm":
        x = _ssm_stack_apply(bp["stack"], x, cfg)
    else:
        for i in range(_n_dense(cfg)):
            x, _ = run_block(attn_block_apply, cfg, bp[f"dense{i}"], x, cfg)
        for i in range(depth(bp["stack"])):
            x, a = run_block(attn_block_apply, cfg, layer(bp["stack"], i),
                             x, cfg)
            aux = {k: aux[k] + a[k] for k in aux}
    x = L.norm_apply(params["final_ln"], x, cfg)
    return L.unembed_apply(params["embed"], x, cfg), aux


def lm_cache(cfg: ModelConfig, plan, batch: int, max_len: int, dtype,
             device=None):
    """Zero decode cache for the whole stack, every leaf with its leading
    layer axes: dense and moe ``{"stack": {"k", "v": (L, B, T, Hkv, D),
    "pos_ids": (L, B, T)}}`` (T the ring ``min(max_len, window)`` for a
    sliding window), with the moe stack's ``dense{i}`` blocks beside it,
    ``(B, T, ...)`` each (MLA: ``c_kv`` (L, B, T, r), ``k_rope``
    (L, B, T, rope) and ``pos_ids``); ssm ``{"stack": {"ssm": (L, B, H,
    P, N), "conv": (L, B, d_inner, K - 1)}}``; hybrid ``{"groups":
    (n_groups, k, B, ...) states, "shared_attn": (n_groups, B, T, ...)
    K/V, "tail": (r, B, ...) states or {}}``. Hkv is the plan's."""
    check_supported(cfg)
    if cfg.family in ("dense", "moe"):
        n_dense = _n_dense(cfg)
        kv = attn_cache(cfg, plan, batch, max_len, dtype, device)
        return {"stack": _stack([kv] * (cfg.num_layers - n_dense)),
                **{f"dense{i}": attn_cache(cfg, plan, batch, max_len, dtype,
                                           device)
                   for i in range(n_dense)}}
    state = ssm_lib.ssm_state_init(cfg, batch, dtype, device)
    if cfg.family == "ssm":
        return {"stack": _stack([state] * cfg.num_layers)}
    k = cfg.hybrid_attn_every
    n_groups, rem = divmod(cfg.num_layers, k)
    kv = attn_cache(cfg, plan, batch, max_len, dtype, device)
    return {
        "groups": _stack([_stack([state] * k)] * n_groups),
        "shared_attn": _stack([kv] * n_groups),
        "tail": _stack([state] * rem) if rem else {},
    }


def layer_spec(tree, n: int = 1):
    """A spec tree with ``n`` leading (replicated) layer axes added."""
    for _ in range(n):
        tree = tree_map(lambda s: Spec(None, *s), tree)
    return tree


def lm_cache_specs(cfg: ModelConfig, plan, seq_axis=None):
    """The partition specs of :func:`lm_cache`'s tree."""
    a_spec = (attn.mla_cache_spec(plan, seq_axis) if _mla(cfg)
              else attn.gqa_cache_spec(plan, seq_axis))
    s_spec = ssm_lib.ssm_state_spec(plan)
    if cfg.family in ("dense", "moe"):
        c = {"stack": layer_spec(a_spec)}
        for i in range(cfg.first_k_dense):
            c[f"dense{i}"] = a_spec
        return c
    if cfg.family == "ssm":
        return {"stack": layer_spec(s_spec)}
    if cfg.family == "hybrid":
        rem = cfg.num_layers % cfg.hybrid_attn_every
        return {"groups": layer_spec(s_spec, 2),
                "shared_attn": layer_spec(a_spec),
                "tail": layer_spec(s_spec) if rem else {}}
    raise ValueError(cfg.family)


def lm_prefill(params, tokens, cfg: ModelConfig, plan,
               max_len: Optional[int] = None, lengths=None):
    """tokens (B,S) -> (logits, seeded cache with capacity max_len or S).

    ``lengths`` (B,) marks per-row true prompt lengths when the batch is
    right-padded: cache positions past a row's length record
    ``pos_id = -1`` (attention caches only: a recurrent state has no
    position table, so a ragged prefill there runs per request at its exact
    length). The recurrent states are those the scan ends with, stacked as
    the reference stacks them."""
    check_supported(cfg)
    B, S = tokens.shape
    max_len = max_len or S
    dtype = L.cdt(cfg)
    x = L.embed_apply(params["embed"], tokens, cfg)
    bp = params["blocks"]
    if cfg.family == "ssm":
        states = []
        x = _ssm_stack_apply(bp["stack"], x, cfg, states)
        cache: Dict[str, Any] = {"stack": _stack(states)}
    elif cfg.family == "hybrid":
        n_groups = depth(bp["groups"])
        shared = _stack([attn_cache(cfg, plan, B, max_len, dtype,
                                    x.device)] * n_groups)
        g_states, tail = [], []
        for g in range(n_groups):
            states = []
            x = _ssm_stack_apply(layer(bp["groups"], g), x, cfg, states)
            g_states.append(_stack(states))
            x, _, kv = attn_block_apply(bp["shared_attn"], x, cfg,
                                        collect_kv=True)
            seed_attn_cache(cfg, layer(shared, g), kv, lengths=lengths)
        x = _ssm_stack_apply(bp["tail"], x, cfg, tail)
        cache = {"groups": _stack(g_states), "shared_attn": shared,
                 "tail": _stack(tail) if tail else {}}
    else:
        cache = lm_cache(cfg, plan, B, max_len, dtype, x.device)
        for lp, lc in zip(_blocks(bp, cfg), _blocks(cache, cfg)):
            x, _, kv = attn_block_apply(lp, x, cfg, collect_kv=True)
            seed_attn_cache(cfg, lc, kv, lengths=lengths)
    x = L.norm_apply(params["final_ln"], x, cfg)
    return L.unembed_apply(params["embed"], x, cfg), cache


def lm_decode(params, tokens, cache, pos, cfg: ModelConfig, n_valid=None,
              block_table=None, scratch_table=None, null_page=None,
              idle_slots=None):
    """tokens (B,S) -> logits (B,S,V); the cache is updated in place (and
    returned). ``pos`` is a scalar or a (B,) vector of per-slot positions.
    Attention stacks take S > 1 (a chunked-prefill extend) with ``n_valid``
    (B,) marking real tokens per row, and with ``block_table`` (B, n_pages)
    int32 the serving tier's page pool (``lm_cache(cfg, plan, pages,
    page_size, ...)``) as the cache; ``scratch_table`` (B, n_scratch) int32 names
    each slot's scratch pages of the pool, which a chunk on a wrapping
    sliding-window ring passes through (``attention.gqa_decode``), and
    ``null_page`` the page that its unallocated entries name, which MLA's
    decode leaves unwritten (``attention.mla_decode``); ``idle_slots``
    (host ints) the slots with no real token, where an MoE model's paged
    step repairs the rows that see no key (``attention.gqa_decode``). A
    recurrent state advances one token per step, so
    the ssm and hybrid families take S = 1 and the contiguous cache only;
    ``pos`` and ``n_valid`` reach the hybrid's shared attention. A chunk of
    2..16 tokens (a speculative verify, ``L.by_column``) runs the ops whose
    rounding depends on the row count a column at a time, so that each row
    takes the arithmetic of a one-token step."""
    check_supported(cfg)
    cols = L.by_column(tokens.shape[1])
    x = L.tap("embed", L.embed_apply(params["embed"], tokens, cfg))
    bp = params["blocks"]
    if cfg.family in ("ssm", "hybrid"):
        if block_table is not None or tokens.shape[1] != 1:
            raise ValueError(
                f"the {cfg.family} family decodes one token per step on the "
                f"contiguous cache (got S = {tokens.shape[1]}"
                f"{', a block table' if block_table is not None else ''})")
    if cfg.family == "ssm":
        x = _ssm_stack_decode(bp["stack"], x, cache["stack"], cfg)
    elif cfg.family == "hybrid":
        for g in range(depth(bp["groups"])):
            x = _ssm_stack_decode(layer(bp["groups"], g), x,
                                  layer(cache["groups"], g), cfg)
            x, _ = attn_block_decode(bp["shared_attn"], x,
                                     layer(cache["shared_attn"], g), pos, cfg,
                                     n_valid=n_valid)
        x = _ssm_stack_decode(bp["tail"], x, cache["tail"], cfg)
    else:
        for lp, lc in zip(_blocks(bp, cfg), _blocks(cache, cfg)):
            x, _ = attn_block_decode(lp, x, lc, pos, cfg, n_valid=n_valid,
                                     block_table=block_table,
                                     scratch_table=scratch_table,
                                     null_page=null_page,
                                     idle_slots=idle_slots, cols=cols)
    x = L.tap("final_ln", L.norm_apply(params["final_ln"], x, cfg, cols))
    return L.tap("logits", L.unembed_apply(params["embed"], x, cfg)), cache
