"""Mamba2 (SSD, state-space duality) block: the chunked scan for
train/prefill and the one-token recurrence for decode (the counterpart of
the reference's ``models/ssm.py``, arXiv:2405.21060).

Per head, scalar decay A and rank-1 state updates
``S_t = exp(dt A) S_{t-1} + dt B_t x_t``, read out as ``y_t = C_t S_t +
D x_t``. :func:`ssm_apply` runs the chunked scan through the model's kernel
table (``attention.KERNELS["mamba"]``: the Mamba2 scan kernel on the card,
its plain version on the CPU or under ``attention.plain_kernels()``), where
the reference calls its oracle :func:`ssd_chunked`, which is kept here in
the reference's form. The kernel takes the (b, S, G, N) projections of B
and C as they are (head h reads group h // (H / G)) and returns the final
state beside y. :func:`ssm_decode` is plain tensor math, as in the
reference, and updates its state in place. Weights arrive in the compute
dtype (``Model``'s cast copy); ``A_log`` and the norm scale stay float32.

Inside an ``sharding.spmd.region`` (the train step across ranks)
:func:`ssm_apply` runs this rank's ``H / tp`` heads: ``wz``, ``wx``,
``wdt``, the conv, ``A_log``, ``D``, ``dt_bias`` and the norm scale come
cut to its ``d_inner / tp`` channels and heads by the plan (the conv is
depthwise: no collective), ``x`` enters the block, the whole ``wB`` and
``wC`` enter too (each rank's heads read them, so their gradients sum over
the model axis) and are cut to the groups its heads read, the gated
norm's mean over the whole ``d_inner`` sums each rank's squares
(``spmd.all_sum``), and the partial products of the row-parallel ``wo``
sum over the model axis (``spmd.leave``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import rms_norm
from repro_torch.models.params import ParamMeta, dense
from repro_torch.sharding import spmd
from repro_torch.sharding.plan import Spec


def ssm_params(cfg: ModelConfig):
    d, din = cfg.d_model, cfg.d_inner
    H, N, G = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_ngroups
    K = cfg.ssm_conv
    return {
        "wz": dense(d, din, "embed", "dinner"),
        "wx": dense(d, din, "embed", "dinner"),
        "wB": ParamMeta((d, G, N), ("embed", None, None), fan_in=d),
        "wC": ParamMeta((d, G, N), ("embed", None, None), fan_in=d),
        "wdt": ParamMeta((d, H), ("embed", "ssm_heads"), fan_in=d),
        "conv_w": ParamMeta((din, K), ("dinner", None), init="small",
                            fan_in=K),
        "conv_b": ParamMeta((din,), ("dinner",), init="zeros"),
        "A_log": ParamMeta((H,), ("ssm_heads",), init="ones"),
        "D": ParamMeta((H,), ("ssm_heads",), init="ones"),
        "dt_bias": ParamMeta((H,), ("ssm_heads",), init="zeros"),
        "norm": ParamMeta((din,), ("dinner",), init="ones"),
        "wo": dense(din, d, "dinner", "embed"),
    }


def _causal_conv(x, w, b, window: int):
    """Depthwise causal conv by shifted adds. x (B, S, C), w (C, K)."""
    S = x.shape[1]
    out = b.to(x.dtype) * torch.ones_like(x)
    for k in range(window):
        shift = window - 1 - k
        xs = F.pad(x, (0, 0, shift, 0))[:, :S]
        out = out + xs * w[:, k].to(x.dtype)
    return out


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _group_proj(x, w):
    """x (..., d) @ w (d, G, N) -> (..., G, N)."""
    return (x @ w.reshape(w.shape[0], -1)).reshape(*x.shape[:-1],
                                                   *w.shape[1:])


def _segsum_exp(dA):
    """L[i, j] = exp(sum_{j<k<=i} dA_k) for i >= j, else 0. dA (..., Q).
    The masked (i < j) differences are positive, so they are clamped before
    the exponential."""
    Q = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=dA.device))
    return torch.exp(torch.where(mask, diff, -1e30))


def ssd_chunked(xh, dt, A, B, C, chunk: int):
    """The reference's SSD scan, in its form. xh (b, S, H, P), dt (b, S, H),
    A (H,), B and C (b, S, H, N) -> (y in xh's dtype, final state
    (b, H, P, N) float32); all math in float32."""
    b, S, H, P = xh.shape
    N = B.shape[-1]
    Q = min(chunk, S)
    nc = S // Q
    dtype = xh.dtype
    xh = xh.float().reshape(b, nc, Q, H, P)
    dt = dt.float().reshape(b, nc, Q, H)
    B = B.float().reshape(b, nc, Q, H, N)
    C = C.float().reshape(b, nc, Q, H, N)
    dAh = (dt * A.float()).movedim(-1, -2)  # (b, nc, H, Q)
    L = _segsum_exp(dAh)
    G = torch.einsum("bcqhn,bckhn->bchqk", C, B)
    y_intra = torch.einsum("bchqk,bckh,bckhp->bcqhp", G * L, dt, xh)
    cs = torch.cumsum(dAh, dim=-1)
    decay_to_end = torch.exp(cs[..., -1:] - cs)
    chunk_state = torch.einsum("bchq,bcqh,bcqhn,bcqhp->bchpn",
                               decay_to_end, dt, B, xh)
    chunk_decay = torch.exp(dAh.sum(-1))  # (b, nc, H)
    s = torch.zeros((b, H, P, N), dtype=torch.float32, device=xh.device)
    states_in = []
    for c in range(nc):  # the reference's lax.scan over chunks
        states_in.append(s)
        s = s * chunk_decay[:, c, :, None, None] + chunk_state[:, c]
    states_in = torch.stack(states_in, dim=1)  # (b, nc, H, P, N)
    y_inter = torch.einsum("bcqhn,bchq,bchpn->bcqhp", C, torch.exp(cs),
                           states_in)
    y = (y_intra + y_inter).reshape(b, S, H, P).to(dtype)
    return y, s


def _local_groups(w, cfg: ModelConfig, tp: int):
    """The B or C projection ``w`` (d, G, N) cut to the groups that this
    rank's heads read (head h reads group h // (H / G)): G / tp groups from
    ``tp_rank * G / tp`` where tp divides G, the one group ``tp_rank //
    (tp / G)`` where G divides tp (G = 1: the whole ``w``); else a rank's
    heads would read groups at offsets the scan's rule does not give, and
    this raises."""
    G = cfg.ssm_ngroups
    if tp == 1 or G == 1:
        return w
    r = spmd.REGION.tp_rank
    if G % tp == 0:
        g = G // tp
        return w[:, r * g:(r + 1) * g]
    if tp % G == 0:
        g = r // (tp // G)
        return w[:, g:g + 1]
    raise ValueError(f"{cfg.name}: {G} B/C groups over {tp} tensor-parallel "
                     f"ranks: neither divides the other, so a rank's heads "
                     f"do not read whole groups")


def _gated_norm(y, scale, cfg: ModelConfig, tp: int):
    """The gated RMS norm over the whole ``d_inner``: inside an
    ``spmd.region`` y holds this rank's channels, and the sum of squares
    adds up over the model axis."""
    if tp == 1:
        return rms_norm(y, scale, cfg.norm_eps)
    dt = y.dtype
    y = y.float()
    ss = spmd.all_sum(y.square().sum(-1, keepdim=True))
    y = y * torch.rsqrt(ss / cfg.d_inner + cfg.norm_eps)
    return (y * scale.float()).to(dt)


def ssm_apply(p, x, cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """Train/prefill. x (B, S, D) -> (out, {"ssm": final state, "conv": the
    raw pre-conv tail}) — the state that seeds decode. Inside an
    ``spmd.region`` the heads, channels and state are this rank's (module
    docstring); under sequence parallelism x is this rank's sequence
    shard, gathered on the way in (the conv and the scan take the whole
    sequence) and the output scattered back to the shard."""
    x = spmd.enter_seq(x)
    Bsz, S, _ = x.shape
    H, P = p["A_log"].shape[0], cfg.ssm_head_dim  # this rank's heads
    tp = cfg.ssm_heads // H
    z = x @ p["wz"]
    xr_raw = x @ p["wx"]
    xin = F.silu(_causal_conv(xr_raw, p["conv_w"], p["conv_b"],
                              cfg.ssm_conv))
    wB = _local_groups(spmd.enter(p["wB"]), cfg, tp)
    wC = _local_groups(spmd.enter(p["wC"]), cfg, tp)
    Bm = _group_proj(x, wB).contiguous()
    Cm = _group_proj(x, wC).contiguous()
    dt = _softplus(x @ p["wdt"] + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    xh = xin.reshape(Bsz, S, H, P)
    y, state = attn.KERNELS["mamba"](xh, dt, A, Bm, Cm, chunk=cfg.ssm_chunk)
    y = y + xh * p["D"][None, None, :, None]
    y = y.reshape(Bsz, S, H * P)
    y = _gated_norm(y * F.silu(z), p["norm"], cfg, tp)
    out = spmd.leave_seq(y @ p["wo"])
    conv_raw = xr_raw.transpose(1, 2)[:, :, -(cfg.ssm_conv - 1):]
    return out, {"ssm": state, "conv": conv_raw.contiguous()}


def ssm_state_init(cfg: ModelConfig, batch: int, dtype, device=None):
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    return {
        "ssm": torch.zeros((batch, H, P, N), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((batch, cfg.d_inner, cfg.ssm_conv - 1),
                            dtype=dtype, device=device),
    }


def ssm_state_spec(plan):
    b = plan.batch_axes
    return {"ssm": Spec(b, plan.rules.get("ssm_heads"), None, None),
            "conv": Spec(b, plan.rules.get("dinner"), None)}


def ssm_decode(p, x, state, cfg: ModelConfig):
    """One-token recurrent step. x (B, 1, D); ``state`` is updated in place
    (and returned)."""
    Bsz = x.shape[0]
    dt_ = x.dtype
    H, P, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_ngroups
    xt = x[:, 0]
    z = xt @ p["wz"]
    xr = xt @ p["wx"]  # (B, din), raw pre-conv
    conv_hist = torch.cat([state["conv"], xr[:, :, None]], dim=2)
    xin = (conv_hist.float() * p["conv_w"].float()).sum(-1).to(dt_)
    xin = F.silu(xin + p["conv_b"])
    heads = torch.arange(H, device=x.device) // (H // G)
    Bh = _group_proj(xt, p["wB"])[:, heads].float()  # (B, H, N)
    Ch = _group_proj(xt, p["wC"])[:, heads].float()
    dt = _softplus(xt @ p["wdt"] + p["dt_bias"]).float()  # (B, H)
    A = -torch.exp(p["A_log"].float())
    xh = xin.reshape(Bsz, H, P).float()
    decay = torch.exp(dt * A)
    s = state["ssm"] * decay[..., None, None] + (
        dt[:, :, None, None] * xh[..., None]) * Bh[:, :, None, :]
    y = (s @ Ch[..., None])[..., 0].to(dt_)  # (B, H, P)
    y = y + xh.to(dt_) * p["D"][None, :, None]
    y = y.reshape(Bsz, cfg.d_inner)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = (y @ p["wo"])[:, None]
    state["ssm"].copy_(s)
    state["conv"].copy_(conv_hist[:, :, 1:])
    return out, state
