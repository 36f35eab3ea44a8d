"""Mixture-of-Experts: top-k router and capacity-bounded scatter dispatch
(the counterpart of the reference's ``models/moe.py``).

Dispatch is scatter/gather based, GShard-style: each route's slot in its
expert's buffer is its position among the routes to that expert, from a
one-hot cumsum over the group's routes flattened token-major, then by rank
(``idx.reshape(n, T * k)``); routes at or past ``capacity`` are dropped (a
zero row in the overflow slot, weight 0 in the combine). The capacity is
per dispatch group, so the routes of every row of a step, idle slots and
padded chunk tails included, compete for it, as in the reference.

The experts' SwiGLU runs as batched products over (experts, capacity)
buffers: plain ``torch.matmul``, which the reference computes outside any
kernel too. The reference's ``lax.scan`` over groups is a Python loop here.

Inside an ``sharding.spmd.region`` (the train step across ranks) the layer
is the reference's under its plan. Each data rank dispatches its own rows
in groups of its own (the reference's shard-local grouping, whose
capacity is a data shard's group's), and the router's mean probabilities
and z-loss are means over every data rank's groups (``spmd.all_sum`` over
the data axis: the reference's ``router_topk`` over ``(n_dp, gs, E)``
logits). The router runs whole on every rank of the model axis; the
experts are this rank's share (``plan.expert_mode``): E / tp whole experts
(``ep``) or ``moe_d_ff / tp`` columns of every expert (``tp``). The
tokens and combine weights enter the experts' path (``spmd.enter``), the
rank fills only its experts' slots, and the combined output, partial in
both modes, sums over the model axis (``spmd.leave``). Outside a region
(serving, one process) a dispatch group is the reference's on one shard
(``n_dp = 1``).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Iterator, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.params import ParamMeta, dense
from repro_torch.sharding import spmd

_SINK: contextvars.ContextVar = contextvars.ContextVar("moe_routes",
                                                      default=None)


@contextlib.contextmanager
def capture_routes() -> Iterator[List[Dict[str, torch.Tensor]]]:
    """Collect the routes of every dispatch run inside the block, in call
    order, into the list it yields: one dict per dispatch, of tensors it
    computed anyway: ``idx`` (n, T, k) the experts chosen, ``keep``
    (n, T * k) the routes within capacity, ``logits`` (n, T, E) the
    router's logits (:func:`route_margin`). Outside such a block (and in
    other threads) nothing is kept."""
    sink: List[Dict[str, torch.Tensor]] = []
    token = _SINK.set(sink)
    try:
        yield sink
    finally:
        _SINK.reset(token)


def moe_params(cfg: ModelConfig):
    d, ff, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    p = {
        "router": dense(d, E, "embed", None),
        "wg": ParamMeta((E, d, ff), ("experts", "embed", "expert_ffn"),
                        fan_in=d),
        "wu": ParamMeta((E, d, ff), ("experts", "embed", "expert_ffn"),
                        fan_in=d),
        "wd": ParamMeta((E, ff, d), ("experts", "expert_ffn", "embed"),
                        fan_in=ff),
    }
    if cfg.num_shared_experts:
        p["shared"] = L.mlp_params(
            cfg, d_ff=cfg.num_shared_experts * cfg.moe_d_ff)
    return p


def capacity(cfg: ModelConfig, group: int) -> int:
    """Slots per expert in a dispatch group of ``group`` tokens."""
    return max(int(group * cfg.num_experts_per_tok
                   * cfg.moe_capacity_factor / cfg.num_experts), 4)


def _topk_sorted(probs, k: int):
    """(weights, indices) of the k largest, the lower index first on a tie
    (``jax.lax.top_k``'s order; ``torch.topk`` promises none on the card),
    and the full descending sort's values."""
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    return srt.values[..., :k], srt.indices[..., :k], srt.values


def router_topk(logits, k: int):
    """Softmax-then-top-k with renormalized weights (+ aux losses).

    logits (..., E) -> weights and indices (..., k), aux and z scalars
    (means over all leading dims), all float32. Inside an
    ``spmd.region`` with a data axis the means run over every data rank's
    logits of the same shape (each rank's mean, averaged with
    ``spmd.all_sum``: the gradient of the product of means reaches every
    rank's probabilities), so aux and z are the whole batch's on every
    rank."""
    probs = torch.softmax(logits.float(), dim=-1)
    w, idx, _ = _topk_sorted(probs, k)
    w = w / (w.sum(-1, keepdim=True) + 1e-9)
    E = logits.shape[-1]
    lead = tuple(range(logits.dim() - 1))
    me = probs.mean(dim=lead)
    ce = F.one_hot(idx, E).float().sum(-2).mean(dim=lead) / k
    z = torch.logsumexp(logits.float(), -1).square().mean()
    n_dp = spmd.size("data")
    if n_dp > 1:
        me = spmd.all_sum(me, "data") / n_dp
        ce = spmd.all_reduce(ce, spmd.REGION.dp) / n_dp
        z = spmd.all_sum(z, "data") / n_dp
    aux = E * torch.sum(me * ce)
    return w, idx, aux, z


def route_margin(logits, k: int):
    """(...,) the k-th less the (k + 1)-th router probability of each
    token: how near a tie its route is (1 with no (k + 1)-th expert)."""
    srt = _topk_sorted(torch.softmax(logits.float(), dim=-1), k)[2]
    if srt.shape[-1] == k:
        return torch.ones_like(srt[..., 0])
    return srt[..., k - 1] - srt[..., k]


def _positions(idx, E: int):
    """(flat_e, pos), each (n, T * k): the routes' experts flattened
    token-major, then by rank, and each route's position among the
    group's routes to its expert."""
    flat_e = idx.reshape(idx.shape[0], -1)
    onehot = F.one_hot(flat_e, E)  # (n, T*k, E)
    pos_in_e = torch.cumsum(onehot, dim=1) - onehot
    return flat_e, torch.gather(pos_in_e, 2, flat_e[..., None])[..., 0]


def _experts(p, x, w, flat_e, pos, keep, cap: int, cfg: ModelConfig):
    """The kept routes of x (n, T, D) through their experts' SwiGLU, route
    (e, pos) in slot ``e * cap + pos`` of (E, cap) buffers, combined with
    the router's weights w (n, T, k) -> (n, T, D). Inside an
    ``spmd.region`` the weights are this rank's: E_loc = E / tp experts
    from ``tp_rank * E_loc`` (``ep``: the buffers hold those experts'
    slots alone, the other routes drop out here) or every expert's columns
    (``tp``); either way the result is this rank's part of the sum over
    the model axis, and x and w enter the region."""
    n, T, D = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    dt = x.dtype
    E_loc = p["wg"].shape[0]
    if E_loc < E:  # ep: this rank's experts alone
        e0 = spmd.REGION.tp_rank * E_loc
        keep = keep & (flat_e >= e0) & (flat_e < e0 + E_loc)
        flat_e = flat_e - e0
    x, w = spmd.enter(x), spmd.enter(w)
    slot = torch.where(keep, flat_e * cap + pos,
                       torch.full_like(pos, E_loc * cap))  # (n, T*k)
    # each kept route's token into its slot; the dropped ones (zeros) all
    # land in the overflow row, which is cut off
    xs = x.repeat_interleave(k, dim=1) * keep[..., None].to(dt)
    buf = x.new_zeros((n, E_loc * cap + 1, D))
    buf.scatter_(1, slot[..., None].expand(n, T * k, D), xs)
    buf = buf[:, :-1].reshape(n, E_loc, cap, D)

    # the experts' SwiGLU, batched over groups x experts
    h = F.silu(buf @ p["wg"]) * (buf @ p["wu"])
    out_buf = h @ p["wd"]  # (n, E_loc, cap, D)

    flat = out_buf.reshape(n, E_loc * cap, D)
    safe = torch.clamp(slot, max=E_loc * cap - 1)
    gathered = torch.gather(flat, 1, safe[..., None].expand(n, T * k, D))
    gathered = gathered * (keep[..., None]
                           * w.reshape(n, T * k)[..., None]).to(dt)
    return gathered.reshape(n, T, k, D).sum(2)


def _record(idx, keep, logits):
    sink = _SINK.get()
    if sink is not None:
        sink.append({"idx": idx, "keep": keep, "logits": logits})


def _dispatch_batched(p, x, cfg: ModelConfig, cap: int):
    """x (n, T, D): n dispatch groups -> (out (n, T, D), aux, z)."""
    logits = x @ p["router"]
    w, idx, aux, z = router_topk(logits, cfg.num_experts_per_tok)
    flat_e, pos = _positions(idx, cfg.num_experts)
    keep = pos < cap
    _record(idx, keep, logits)
    return _experts(p, x, w, flat_e, pos, keep, cap, cfg), aux, z


def _dispatch_cols(p, x, cfg: ModelConfig, cap: int):
    """x (B, S, D), the B * S tokens of a speculative verify in one
    dispatch group (``L.by_column``) -> (out (B, S, D), aux, z). The capacity is the group's, as in
    :func:`_dispatch_batched`: the routes compete for it token-major over
    (slot, column). The rest runs a column at a time on the column's
    (1, B, D) slab, as a decode tick of those B tokens runs it: the
    router's product and top-k, and the experts' products over
    (E, cap_col) buffers that hold the column's kept routes at their
    positions among the column's routes. ``cap_col`` is the decode tick's
    capacity wherever that holds every kept route: wherever it is at least
    min(B, cap), as at the configs' capacities and at a dropless one. So a
    row whose routes the group keeps as the decode tick keeps them takes
    its decode row's arithmetic."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    xs = [t.reshape(1, B, D) for t in L.columns(x, True)]
    logits = [t @ p["router"] for t in xs]
    routed = [router_topk(lg, k) for lg in logits]
    idx = torch.stack([r[1][0] for r in routed], 1).reshape(1, B * S, k)
    keep = (_positions(idx, E)[1] < cap).reshape(B, S * k)
    joined = torch.stack([lg[0] for lg in logits], 1).reshape(1, B * S, E)
    _, _, aux, z = router_topk(joined, k)
    _record(idx, keep.reshape(1, B * S * k), joined)
    # a kept route's place among its column's routes to its expert is at
    # most its place in the group, and under B (a token's experts differ)
    cap_col = max(capacity(cfg, B), min(B, cap))
    outs = [_experts(p, t, w, *_positions(ix, E),
                     keep[:, j * k:(j + 1) * k].reshape(1, B * k),
                     cap_col, cfg)[0]
            for j, (t, (w, ix, _, _)) in enumerate(zip(xs, routed))]
    return torch.stack(outs, 1), aux, z


def moe_apply(p, x, cfg: ModelConfig, cols: bool = False
              ) -> Tuple[torch.Tensor, Dict]:
    """x (B, S, D) -> (out, {moe_aux, moe_z}) with shared experts added.
    The B * S tokens are dispatched in groups of ``cfg.moe_group_size``
    (one group when 0 or larger than B * S; inside an ``spmd.region`` B
    is this data rank's rows, so its groups are shard-local, as the
    reference's under a mesh). Under sequence parallelism x is this
    rank's sequence shard: the router and the dispatch take it gathered
    (``spmd.whole_seq``), so the groups and capacities are those of the
    step without the flag, the combined output is scattered back to the
    shard (``spmd.leave_seq``), and the shared experts gather their own
    input as the MLP does. A row's routes depend on the other rows of
    its group (they share the capacity). ``cols`` (a decode
    chunk of 2..16 rows, ``L.by_column``) in one group: the group's
    routes, the rest a column at a time (:func:`_dispatch_cols`), and the
    shared experts as the MLP (:func:`L.mlp_apply`)."""
    x_in, x = x, spmd.whole_seq(x)
    B, S, D = x.shape
    T = B * S
    gs = min(cfg.moe_group_size or T, T)
    if T % gs:
        raise ValueError(f"{T} tokens do not split into dispatch groups of "
                         f"{gs}")
    cap = capacity(cfg, gs)
    if cols and gs == T:
        out, aux, z = _dispatch_cols(p, x, cfg, cap)
        auxs, zs = [aux], [z]
    else:
        outs, auxs, zs = [], [], []
        for xg in x.reshape(T // gs, 1, gs, D):  # the reference's scan
            o, aux, z = _dispatch_batched(p, xg, cfg, cap)
            outs.append(o)
            auxs.append(aux)
            zs.append(z)
        out = spmd.leave_seq(torch.cat(outs, dim=0).reshape(B, S, D))
    out = L.tap("experts", out)
    if cfg.num_shared_experts:
        out = out + L.mlp_apply(p["shared"], x_in, cfg, cols)
    losses = {"moe_aux": torch.stack(auxs).mean(),
              "moe_z": torch.stack(zs).mean()}
    return out, losses
