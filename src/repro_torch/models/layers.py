"""Core layers: norms, MLPs, embeddings, rotary position embedding (the
counterpart of the reference's ``models/layers.py``).

Functional style: ``*_params(cfg)`` builds a ParamMeta tree, ``*_apply(p, x,
...)`` runs the layer. Compute dtype is ``cfg.dtype`` (bf16); parameters are
stored in ``cfg.param_dtype``. The reference casts each weight at every use;
here the caller hands the layers weights already cast to the compute dtype
(``Model`` keeps one cast copy, the same values), while norm scales are read
in float32 as the reference reads them. The vocabulary is the plan's
(``sharding.plan``): padded to a multiple of 128 without a mesh, and of
``max(128, tp)`` with one.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import paged_attention as PA
from repro_torch.models.params import ParamMeta, dense, torch_dtype
from repro_torch.sharding import spmd

#: a list that a model step records its named intermediates into, as
#: ``(name, tensor)`` pairs (``chip_smoke.py``'s row-invariance probe);
#: None records nothing
TAPE = None


def cdt(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.dtype)


def tap(name: str, x):
    """Record ``x`` under ``name`` on the tape, if one is set; return x."""
    if TAPE is not None:
        TAPE.append((name, x.detach().clone()))
    return x


def by_column(S: int) -> bool:
    """Whether a decode chunk of width S (a speculative verify: the last
    token and its drafts) runs the ops whose rounding depends on the row
    count once per column, on a contiguous ``(B, 1, ...)`` slab: the call a
    decode tick makes, with the same shape, strides and alignment, so that
    cuBLAS and PyTorch's reductions pick the same algorithm and every row of
    the chunk takes its decode row's arithmetic. Those ops are the MLP's
    products, the norms' float32 means, MLA's projections and attention,
    and the MoE layer's router and experts (the capacity stays the
    chunk's); on an H100 the GQA projections of llama3.2-1b round a row
    alike at 8 and 32 rows, while the shared experts' gate product of
    deepseek-v2 does not. The width
    is the paged kernel's, which scores a chunk of at most
    ``PA.CHUNK_ROWS`` rows so by itself; wider chunks (prefill) take every
    op whole."""
    return 1 < S <= PA.CHUNK_ROWS


def columns(x, cols: bool):
    """x (B, S, ...) as the tensors an op of :func:`by_column` takes: ``[x]``, or with ``cols`` its S columns, each a contiguous
    (B, 1, ...) slab of one (S, B, ...) tensor (a view of x when x is laid
    out so already, else one copy)."""
    if not cols:
        return [x]
    return [s.unsqueeze(1) for s in x.transpose(0, 1).contiguous()]


def column_map(fn, x, cols: bool, tail):
    """``fn(x, None)``, or with ``cols`` ``fn(column, out=slab)`` for each of
    x's columns (:func:`columns`), each writing its (B, 1, *tail) result
    into one (S, B, 1, *tail) tensor, returned as its (B, S, *tail) view: so
    the next op's columns are views of it, with no copy."""
    if not cols:
        return fn(x, None)
    B, S = x.shape[:2]
    out = torch.empty((S, B, 1, *tail), dtype=x.dtype, device=x.device)
    for j, t in enumerate(columns(x, True)):
        fn(t, out[j])
    return out.squeeze(2).transpose(0, 1)


def join(parts):
    """The results of :func:`columns`' tensors, joined along S."""
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def mean_last(x, cols: bool = False):
    """``x.mean(-1, keepdim=True)``, a column at a time with ``cols``."""
    return column_map(lambda t, out: torch.mean(t, -1, keepdim=True, out=out),
                      x, cols, (*x.shape[2:-1], 1))


# --- dense-matmul routing hook ------------------------------------------------

#: optional override for the dense matmuls of the MLP blocks: a callable
#: ``(x_2d_f32, w_2d_f32) -> y_2d_f32``. None keeps the plain ``@``.
MATMUL = None


def matmul(x, w, cols: bool = False):
    """x: (B, S, K) @ w: (K, N), through the routing hook when installed;
    ``cols``: a column at a time (:func:`column_map`)."""
    if MATMUL is None:
        return column_map(lambda t, out: torch.matmul(t, w, out=out), x,
                          cols, (w.shape[-1],))
    return join([MATMUL(t.reshape(-1, t.shape[-1]).float(), w.float())
                 .reshape(*t.shape[:-1], w.shape[-1]).to(x.dtype)
                 for t in columns(x, cols)])


# --- norms -------------------------------------------------------------------

def norm_params(cfg: ModelConfig, dim: Optional[int] = None, logical="embed"):
    d = dim or cfg.d_model
    p = {"scale": ParamMeta((d,), (logical,), init="ones")}
    if cfg.norm_type == "layernorm":
        p["bias"] = ParamMeta((d,), (logical,), init="zeros")
    return p


def norm_apply(p, x, cfg: ModelConfig, cols: bool = False):
    """Under sequence parallelism x is this rank's sequence shard of the
    residual stream, so the scale's and bias's gradients sum over the
    model axis (``spmd.seq_param``)."""
    dt = x.dtype
    x = x.float()
    if cfg.norm_type == "layernorm":
        x = x - mean_last(x, cols)
    var = mean_last(x.square(), cols)
    x = x * torch.rsqrt(var + cfg.norm_eps)
    x = x * spmd.seq_param(p["scale"]).float()
    if cfg.norm_type == "layernorm":
        x = x + spmd.seq_param(p["bias"]).float()
    return x.to(dt)


def rms_norm(x, scale, eps=1e-5, cols: bool = False):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(mean_last(x.square(), cols) + eps)
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


def mlp_apply(p, x, cfg: ModelConfig, cols: bool = False):
    """``p`` holds the weights in x's dtype; ``cols``: each product one
    column at a time (:func:`by_column`). Inside an ``spmd.region`` the
    weights are this rank's columns of the up products and rows of the
    down product, whose partial outputs sum over the model axis (under
    sequence parallelism x is a sequence shard, gathered on the way in, and
    the output is scattered back to one: ``spmd.enter_seq`` /
    ``leave_seq``)."""
    x = spmd.enter_seq(x)
    mm = lambda t, w, name: tap(name, matmul(t, w, cols))
    if cfg.mlp_type == "swiglu":
        h = F.silu(mm(x, p["wg"], "gate")) * mm(x, p["wu"], "up")
    elif cfg.mlp_type == "relu2":
        h = torch.square(F.relu(mm(x, p["wu"], "up")))
    else:  # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(mm(x, p["wu"], "up"), approximate="tanh")
    return spmd.leave_seq(tap("down", matmul(h, p["wd"], cols)))


# --- embeddings ----------------------------------------------------------------

def embed_params(cfg: ModelConfig, plan):
    v = plan.vocab
    p = {"embedding": ParamMeta((v, cfg.d_model), ("vocab", "embed"),
                                init="embed", fan_in=cfg.d_model)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense(cfg.d_model, v, "embed", "vocab")
    return p


def embed_apply(p, tokens, cfg: ModelConfig):
    """``p["embedding"]`` in the compute dtype (inside an ``spmd.region``
    this rank's rows of the vocabulary; under sequence parallelism the
    lookup is this rank's sequence shard)."""
    if spmd.REGION is not None:
        return spmd.embed(p["embedding"], tokens)
    return p["embedding"][tokens.long()]


def unembed_apply(p, x, cfg: ModelConfig):
    """Logits over the vocabulary (inside an ``spmd.region`` over this
    rank's share of it, for the whole sequence: under sequence parallelism
    x is gathered first)."""
    x = spmd.enter_seq(x)
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
