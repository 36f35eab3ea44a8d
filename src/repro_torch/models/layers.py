"""Core layers: norms, MLPs, embeddings, rotary position embedding (the
counterpart of the reference's ``models/layers.py``).

Functional style: ``*_params(cfg)`` builds a ParamMeta tree, ``*_apply(p, x,
...)`` runs the layer. Compute dtype is ``cfg.dtype`` (bf16); parameters are
stored in ``cfg.param_dtype``. The reference casts each weight at every use;
here the caller hands the layers weights already cast to the compute dtype
(``Model`` keeps one cast copy, the same values), while norm scales are read
in float32 as the reference reads them. One card has no sharding, so the
padded widths of the reference's single-device plan are the config's own:
the vocabulary padded to a multiple of 128.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, pad_to_multiple
from repro_torch.models.params import ParamMeta, dense, torch_dtype


def cdt(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.dtype)


def padded_vocab(cfg: ModelConfig) -> int:
    return pad_to_multiple(cfg.vocab_size, 128)


# --- dense-matmul routing hook ------------------------------------------------

#: optional override for the dense matmuls of the MLP blocks: a callable
#: ``(x_2d_f32, w_2d_f32) -> y_2d_f32``. None keeps the plain ``@``.
MATMUL = None


def matmul(x, w):
    """x: (..., K) @ w: (K, N), through the routing hook when installed."""
    if MATMUL is None:
        return x @ w
    y = MATMUL(x.reshape(-1, x.shape[-1]).float(), w.float())
    return y.reshape(*x.shape[:-1], w.shape[-1]).to(x.dtype)


# --- norms -------------------------------------------------------------------

def norm_params(cfg: ModelConfig, dim: Optional[int] = None, logical="embed"):
    d = dim or cfg.d_model
    p = {"scale": ParamMeta((d,), (logical,), init="ones")}
    if cfg.norm_type == "layernorm":
        p["bias"] = ParamMeta((d,), (logical,), init="zeros")
    return p


def norm_apply(p, x, cfg: ModelConfig):
    dt = x.dtype
    x = x.float()
    if cfg.norm_type == "layernorm":
        x = x - x.mean(-1, keepdim=True)
    var = x.square().mean(-1, keepdim=True)
    x = x * torch.rsqrt(var + cfg.norm_eps)
    x = x * p["scale"].float()
    if cfg.norm_type == "layernorm":
        x = x + p["bias"].float()
    return x.to(dt)


def rms_norm(x, scale, eps=1e-5):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


# --- MLP ---------------------------------------------------------------------

def mlp_params(cfg: ModelConfig, d_ff: Optional[int] = None,
               ffn_logical="ffn"):
    ff = d_ff or cfg.d_ff
    d = cfg.d_model
    p = {"wd": dense(ff, d, ffn_logical, "embed")}
    if cfg.mlp_type == "swiglu":
        p["wg"] = dense(d, ff, "embed", ffn_logical)
        p["wu"] = dense(d, ff, "embed", ffn_logical)
    else:  # relu2 | gelu
        p["wu"] = dense(d, ff, "embed", ffn_logical)
    return p


def mlp_apply(p, x, cfg: ModelConfig):
    """``p`` holds the weights in x's dtype."""
    if cfg.mlp_type == "swiglu":
        h = F.silu(matmul(x, p["wg"])) * matmul(x, p["wu"])
    elif cfg.mlp_type == "relu2":
        h = torch.square(F.relu(matmul(x, p["wu"])))
    else:  # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(matmul(x, p["wu"]), approximate="tanh")
    return matmul(h, p["wd"])


# --- embeddings ----------------------------------------------------------------

def embed_params(cfg: ModelConfig):
    v = padded_vocab(cfg)
    p = {"embedding": ParamMeta((v, cfg.d_model), ("vocab", "embed"),
                                init="embed", fan_in=cfg.d_model)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense(cfg.d_model, v, "embed", "vocab")
    return p


def embed_apply(p, tokens, cfg: ModelConfig):
    """``p["embedding"]`` in the compute dtype."""
    return p["embedding"][tokens.long()]


def unembed_apply(p, x, cfg: ModelConfig):
    if cfg.tie_embeddings:
        logits = x @ p["embedding"].T
    else:
        logits = x @ p["unembed"]
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


# --- rotary -------------------------------------------------------------------

def rope_freqs(cfg: ModelConfig, dim: Optional[int] = None, device=None):
    d = dim or cfg.head_dim
    exps = torch.arange(0, d, 2, dtype=torch.float32, device=device) / d
    return 1.0 / (torch.tensor(cfg.rope_theta, dtype=torch.float32,
                               device=device) ** exps)  # (d/2,)


def apply_rope(x, positions, cfg: ModelConfig, dim: Optional[int] = None):
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    if not cfg.use_rope:
        return x
    d = dim or x.shape[-1]
    inv = rope_freqs(cfg, d, device=x.device)
    ang = positions[..., None].float() * inv  # (..., S, d/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
