"""The VLM (llama-3.2-vision backbone) and Whisper (encoder-decoder) models
(the counterpart of the reference's ``models/multimodal.py``).

The modality frontends are stubs, as in the reference: the caller hands in
precomputed image-patch embeddings ``image_embeds`` (B, num_image_tokens,
d_model) or audio frames ``audio_frames`` (B, encoder_frames, d_model) at
model width; only the transformer backbone is real.

- **VLM**: ``n_groups = num_layers // cross_attn_every`` groups, each
  ``cross_attn_every`` stacked self-attention blocks followed by one gated
  cross-attention block over the image embeddings. Parameters
  ``blocks.groups`` (n_groups, k, ...) and ``blocks.cross`` (n_groups, ...);
  the cache ``self`` (n_groups, k, B, T, ...) and the frozen cross K/V
  ``cross`` (n_groups, B, num_image_tokens, Hkv, D).
- **Whisper**: ``encoder_layers`` bidirectional blocks over the frames with
  sinusoidal positions, then ``num_layers`` decoder blocks (causal self,
  gated cross over the encoder's output, MLP). The cache ``self``
  (L, B, T, ...) and ``cross`` (L, B, encoder_frames, Hkv, D).

The reference's ``lax.scan`` over stacked layers is a Python loop here;
activation checkpointing (``cfg.remat == "full"``) wraps a vlm group (its
self-attention blocks and its cross block) and a whisper layer, as the
reference's ``_maybe_remat`` wraps its scan bodies. The attention is
``models/attention``'s: causal self-attention, the encoder's
non-causal attention and every cross step (prefill and decode) run on the
flash-attention kernel where the head dim fits it (vlm 128, whisper 64);
the decode's self-attention is ``gqa_decode`` on the contiguous cache. The
serving engine does not take these families (it feeds its model tokens
only); ``serve/step``'s prefill and decode steps over a batch dict serve
them, as in the reference.

Inside an ``spmd.region`` (the sharded train step) every attention and MLP
block runs on this rank's heads and columns (``gqa_apply``,
``mlp_apply``): the cross-attention's K/V projections read the image
embeddings or the encoder's output through ``spmd.enter``, so the encoder
output's gradient sums over the model axis at each of the decoder's cross
blocks before it flows back through the encoder (the image embeddings
take none); the cross block's gate multiplies the output after its
``spmd.leave``, so every rank reads the whole output and the gate's
gradient is whole on every rank, as a norm scale's is.

Under sequence parallelism the text stream (vlm) and the decoder stream
(whisper) are split along the sequence over the model axis: the cross
blocks gather their query input as any attention block does, the gate
then multiplies a sequence shard (its gradient summed over the model
axis, as the norms' are: ``spmd.seq_param``), and whisper's decoder adds
the sinusoid's rows of its own shard. The image embeddings and the
encoder output are not split: they enter the cross K/V as without the
flag, and whisper's encoder runs whole (``spmd.no_sequence_split``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models.params import stack_tree
from repro_torch.models.transformer import (_stack, attn_block_apply,
                                            attn_block_decode,
                                            attn_block_params, depth, layer,
                                            layer_spec, run_block, zero_aux)
from repro_torch.sharding import spmd
from repro_torch.sharding.plan import Spec


def _seeded(cfg, kv, batch, max_len, dtype, lengths, plan):
    """One self-attention block's decode cache seeded from its prefill K/V."""
    cache = attn.gqa_cache_init(cfg, batch, max_len, dtype, kv[0].device,
                                plan=plan)
    return attn.gqa_seed_cache(cache, kv, kv[0].shape[1], lengths=lengths)


def _cross_kv(ks, vs):
    return {"k": torch.stack(ks), "v": torch.stack(vs)}


def _cross_step(p, h, kv, cfg: ModelConfig, qk_norm: bool):
    """The gated cross-attention of a decode step over the frozen cross K/V
    (``kv``: {"k", "v"} (B, T, Hkv, D)), without the residual."""
    q = attn._proj(h, p["wq"])
    if qk_norm and cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"], cfg.norm_eps)
    o = attn._out(attn.cross_attend(q, kv["k"], kv["v"]), p["wo"])
    return o * torch.tanh(p["gate"])


# =============================================================================
# VLM: self-attention groups + gated cross-attention blocks
# =============================================================================

def cross_block_params(cfg: ModelConfig, plan):
    return {
        "ln1": L.norm_params(cfg),
        "attn": attn.gqa_params(cfg, cross=True, plan=plan),
        "ln2": L.norm_params(cfg),
        "mlp": L.mlp_params(cfg),
    }


def cross_block_apply(p, x, img, cfg: ModelConfig):
    """-> (x, (k, v)): the cross K/V over ``img`` for the decode cache."""
    h = L.norm_apply(p["ln1"], x, cfg)
    a, kv = attn.gqa_apply(p["attn"], h, cfg, kv_x=img, cross=True)
    x = x + a
    h = L.norm_apply(p["ln2"], x, cfg)
    return x + L.mlp_apply(p["mlp"], h, cfg), kv


def cross_block_decode(p, x, kv_cache, cfg: ModelConfig):
    """Decode with the frozen (prefill-computed) cross K/V."""
    h = L.norm_apply(p["ln1"], x, cfg)
    x = x + _cross_step(p["attn"], h, kv_cache, cfg, qk_norm=True)
    h = L.norm_apply(p["ln2"], x, cfg)
    return x + L.mlp_apply(p["mlp"], h, cfg)


def vlm_params(cfg: ModelConfig, plan):
    k = cfg.cross_attn_every
    n_groups = cfg.num_layers // k
    return {
        "embed": L.embed_params(cfg, plan),
        "final_ln": L.norm_params(cfg),
        "blocks": {
            "groups": stack_tree(stack_tree(
                attn_block_params(cfg, plan=plan), k), n_groups),
            "cross": stack_tree(cross_block_params(cfg, plan), n_groups),
        },
    }


def _vlm_group(sp, cp, x, img, cfg: ModelConfig):
    """One group: its self-attention blocks, then its cross block ->
    (x, each self block's K/V, the cross K/V)."""
    kvs = []
    for i in range(depth(sp)):
        x, _, kv = attn_block_apply(layer(sp, i), x, cfg, collect_kv=True)
        kvs.append(kv)
    x, ckv = cross_block_apply(cp, x, img, cfg)
    return x, kvs, ckv


def _vlm_forward(params, tokens, image_embeds, cfg, max_len=None,
                 lengths=None, plan=None):
    """The forward; with ``max_len`` also the seeded decode cache."""
    x = L.embed_apply(params["embed"], tokens, cfg)
    img = image_embeds.to(x.dtype)
    B, S = tokens.shape
    bp = params["blocks"]
    selfs, cks, cvs = [], [], []
    for g in range(depth(bp["cross"])):
        x, kvs, (ck, cv) = run_block(_vlm_group, cfg, layer(bp["groups"], g),
                                     layer(bp["cross"], g), x, img, cfg)
        if max_len:
            selfs.append(_stack([_seeded(cfg, kv, B, max_len, L.cdt(cfg),
                                         lengths, plan) for kv in kvs]))
            cks.append(ck)
            cvs.append(cv)
    x = L.norm_apply(params["final_ln"], x, cfg)
    logits = L.unembed_apply(params["embed"], x, cfg)
    if not max_len:
        return logits, None
    return logits, {"self": _stack(selfs), "cross": _cross_kv(cks, cvs)}


def vlm_apply(params, tokens, image_embeds, cfg: ModelConfig):
    return _vlm_forward(params, tokens, image_embeds, cfg)[0], \
        zero_aux(tokens.device)


def vlm_prefill(params, tokens, image_embeds, cfg: ModelConfig, plan,
                max_len: Optional[int] = None, lengths=None):
    return _vlm_forward(params, tokens, image_embeds, cfg,
                        max_len or tokens.shape[1], lengths, plan)


def vlm_cache(cfg: ModelConfig, plan, batch: int, max_len: int, dtype,
              device=None):
    k = cfg.cross_attn_every
    n_groups = cfg.num_layers // k
    kv = attn.gqa_cache_init(cfg, batch, max_len, dtype, device, plan=plan)
    shape = (n_groups, batch, cfg.num_image_tokens,
             plan.num_kv_heads, cfg.head_dim)
    return {
        "self": _stack([_stack([kv] * k)] * n_groups),
        "cross": {"k": torch.zeros(shape, dtype=dtype, device=device),
                  "v": torch.zeros(shape, dtype=dtype, device=device)},
    }


def _cross_spec(plan):
    kvh = plan.rules.get("kv_heads")
    spec = Spec(None, plan.batch_axes, None, kvh, None)
    return {"k": spec, "v": spec}


def vlm_cache_specs(cfg: ModelConfig, plan, seq_axis=None):
    return {"self": layer_spec(attn.gqa_cache_spec(plan, seq_axis), 2),
            "cross": _cross_spec(plan)}


def vlm_decode(params, tokens, cache, pos, cfg: ModelConfig, n_valid=None):
    """tokens (B, S) -> logits; the self caches are updated in place."""
    x = L.embed_apply(params["embed"], tokens, cfg)
    bp = params["blocks"]
    for g in range(depth(bp["cross"])):
        sp, sc = layer(bp["groups"], g), layer(cache["self"], g)
        for i in range(depth(sp)):
            x, _ = attn_block_decode(layer(sp, i), x, layer(sc, i), pos, cfg,
                                     n_valid=n_valid)
        x = cross_block_decode(layer(bp["cross"], g), x,
                               layer(cache["cross"], g), cfg)
    x = L.norm_apply(params["final_ln"], x, cfg)
    return L.unembed_apply(params["embed"], x, cfg), cache


# =============================================================================
# Whisper: encoder-decoder
# =============================================================================

def _sin(pos, d: int, dtype):
    """Sinusoidal embedding of float32 positions ``pos`` (...,) ->
    (..., d): sin then cos of ``pos / 10000^(2i/d)``."""
    i = torch.arange(d // 2, dtype=torch.float32, device=pos.device)
    ang = pos[..., None] / torch.pow(
        torch.tensor(10000.0, device=pos.device), 2 * i / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(dtype)


def sinusoidal(S: int, d: int, dtype, device=None):
    return _sin(torch.arange(S, dtype=torch.float32, device=device), d,
                dtype)


def _sin_at(positions, cfg: ModelConfig, dtype):
    """Sinusoidal embedding at absolute ``positions`` (B, S) -> (B, S, d)."""
    return _sin(positions.float(), cfg.d_model, dtype)


def dec_block_params(cfg: ModelConfig, plan):
    return {
        "ln1": L.norm_params(cfg),
        "self_attn": attn.gqa_params(cfg, plan=plan),
        "ln_x": L.norm_params(cfg),
        "cross_attn": attn.gqa_params(cfg, cross=True, plan=plan),
        "ln2": L.norm_params(cfg),
        "mlp": L.mlp_params(cfg),
    }


def whisper_params(cfg: ModelConfig, plan):
    enc_block = {"ln1": L.norm_params(cfg),
                 "attn": attn.gqa_params(cfg, plan=plan),
                 "ln2": L.norm_params(cfg), "mlp": L.mlp_params(cfg)}
    return {
        "embed": L.embed_params(cfg, plan),
        "enc": stack_tree(enc_block, cfg.encoder_layers),
        "enc_ln": L.norm_params(cfg),
        "dec": stack_tree(dec_block_params(cfg, plan), cfg.num_layers),
        "final_ln": L.norm_params(cfg),
    }


def whisper_encode(params, frames, cfg: ModelConfig):
    """frames (B, F, d_model), precomputed (the conv frontend's stub). The
    encoder runs whole over the model axis under sequence parallelism too
    (``spmd.no_sequence_split``), as the reference puts no ``"seq"`` on it."""
    x = frames.to(L.cdt(cfg))
    x = x + sinusoidal(x.shape[1], cfg.d_model, x.dtype, x.device)[None]
    for i in range(depth(params["enc"])):
        x = run_block(_enc_block, cfg, layer(params["enc"], i), x, cfg)
    with spmd.no_sequence_split():
        return L.norm_apply(params["enc_ln"], x, cfg)


def _enc_block(lp, x, cfg: ModelConfig):
    with spmd.no_sequence_split():  # inside: a remat's recompute takes it too
        h = L.norm_apply(lp["ln1"], x, cfg)
        a, _ = attn.gqa_apply(lp["attn"], h, cfg, causal=False)
        x = x + a
        h = L.norm_apply(lp["ln2"], x, cfg)
        return x + L.mlp_apply(lp["mlp"], h, cfg)


def _dec_block(lp, x, enc_out, cfg: ModelConfig):
    """-> (x, self K/V, cross K/V)."""
    h = L.norm_apply(lp["ln1"], x, cfg)
    a, kv = attn.gqa_apply(lp["self_attn"], h, cfg)
    x = x + a
    h = L.norm_apply(lp["ln_x"], x, cfg)
    a, ckv = attn.gqa_apply(lp["cross_attn"], h, cfg, kv_x=enc_out,
                            cross=True)
    x = x + a
    h = L.norm_apply(lp["ln2"], x, cfg)
    return x + L.mlp_apply(lp["mlp"], h, cfg), kv, ckv


def _whisper_forward(params, tokens, frames, cfg, max_len=None,
                     lengths=None, plan=None):
    enc_out = whisper_encode(params, frames, cfg)
    x = L.embed_apply(params["embed"], tokens, cfg)
    B, S = tokens.shape
    # under sequence parallelism x holds this rank's rows of the sequence
    x = x + spmd.seq_chunk(sinusoidal(S, cfg.d_model, x.dtype, x.device)[None])
    selfs, cks, cvs = [], [], []
    for i in range(depth(params["dec"])):
        x, kv, (ck, cv) = run_block(_dec_block, cfg, layer(params["dec"], i),
                                    x, enc_out, cfg)
        if max_len:
            selfs.append(_seeded(cfg, kv, B, max_len, L.cdt(cfg), lengths,
                                 plan))
            cks.append(ck)
            cvs.append(cv)
    x = L.norm_apply(params["final_ln"], x, cfg)
    logits = L.unembed_apply(params["embed"], x, cfg)
    if not max_len:
        return logits, None
    return logits, {"self": _stack(selfs), "cross": _cross_kv(cks, cvs)}


def whisper_apply(params, tokens, frames, cfg: ModelConfig):
    return _whisper_forward(params, tokens, frames, cfg)[0], \
        zero_aux(tokens.device)


def whisper_prefill(params, tokens, frames, cfg: ModelConfig, plan,
                    max_len: Optional[int] = None, lengths=None):
    return _whisper_forward(params, tokens, frames, cfg,
                            max_len or tokens.shape[1], lengths, plan)


def whisper_cache(cfg: ModelConfig, plan, batch: int, max_len: int, dtype,
                  device=None):
    nl = cfg.num_layers
    kv = attn.gqa_cache_init(cfg, batch, max_len, dtype, device, plan=plan)
    shape = (nl, batch, cfg.encoder_frames, plan.num_kv_heads, cfg.head_dim)
    return {
        "self": _stack([kv] * nl),
        "cross": {"k": torch.zeros(shape, dtype=dtype, device=device),
                  "v": torch.zeros(shape, dtype=dtype, device=device)},
    }


def whisper_cache_specs(cfg: ModelConfig, plan, seq_axis=None):
    return {"self": layer_spec(attn.gqa_cache_spec(plan, seq_axis)),
            "cross": _cross_spec(plan)}


def whisper_decode(params, tokens, cache, pos, cfg: ModelConfig,
                   n_valid=None):
    """tokens (B, S) -> logits; the self caches are updated in place. The
    cross step takes no qk-norm, as the reference's takes none."""
    B, S = tokens.shape
    x = L.embed_apply(params["embed"], tokens, cfg)
    x = x + _sin_at(attn.decode_positions(pos, B, S, x.device), cfg, x.dtype)
    for i in range(depth(params["dec"])):
        lp = layer(params["dec"], i)
        h = L.norm_apply(lp["ln1"], x, cfg)
        a, _ = attn.gqa_decode(lp["self_attn"], h,
                               layer(cache["self"], i), pos, cfg,
                               n_valid=n_valid)
        x = x + a
        h = L.norm_apply(lp["ln_x"], x, cfg)
        x = x + _cross_step(lp["cross_attn"], h, layer(cache["cross"], i),
                            cfg, qk_norm=False)
        h = L.norm_apply(lp["ln2"], x, cfg)
        x = x + L.mlp_apply(lp["mlp"], h, cfg)
    x = L.norm_apply(params["final_ln"], x, cfg)
    return L.unembed_apply(params["embed"], x, cfg), cache
