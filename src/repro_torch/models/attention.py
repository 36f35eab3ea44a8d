"""Attention: GQA, MLA with its absorbed decode, cross-attention (the
counterpart of the reference's ``models/attention.py``).

KV caches are dicts of tensors with an explicit per-slot ``pos_ids`` table
(``(B, T)``), so full and ring-buffer (sliding-window) caches share one
masking rule, evaluated per batch row:
    valid(b, t) = 0 <= pos_ids[b, t] <= pos[b]
                  and pos_ids[b, t] > pos[b] - window   (with a window).

Decode is *ragged*: ``pos`` is a scalar or a ``(B,)`` vector of per-slot
positions, and the new-token axis ``S`` may exceed 1 (a chunked-prefill
"extend": each row appends up to S tokens at its own offset; ``n_valid``
marks how many are real, padded tails write ``pos_id = -1``).

Two caches take the decode: the contiguous one (``(B, T, Hkv, D)`` rows,
attention by :func:`_sdpa`) and the paged pool of the serving tier
(``(P, page_size, Hkv, D)`` pages behind a block table, attention by the
paged-attention kernel). Both are updated in place, where the reference
returns new arrays. In ``gqa_apply`` (``Model.apply`` and ``Model.prefill``)
causal self-attention without a window, non-causal attention (whisper's
encoder) and cross-attention run on the flash-attention kernel, the last
two with ``causal=False``, as does the decode's cross step over the frozen
cross K/V (:func:`cross_attend`); the route is decided by shape before the
call: q, k and v of one head dim in ``flash_attention.HEAD_DIMS``.

A sliding-window model (mixtral) keeps a ring of ``T = min(max_len,
window)`` entries per slot: position p lives at ring index ``p % T``, a
chunk's entries wrap index-wise and its padded tails never overwrite live
entries (:func:`_ring_scatter`).

MLA (deepseek-v2) keeps a compressed cache, ``c_kv`` (B, T, kv_lora_rank)
and ``k_rope`` (B, T, rope_dim) rows or their pages, and decodes absorbed:
``k_up`` folded into the query, scores against ``c_kv`` and ``k_rope``,
``v_up`` after the weighted sum. Its prefill (q/k heads of nope + rope =
192, v heads of 128 at full width) and its decode run in plain PyTorch, as
the reference computes them outside any Pallas kernel: the flash kernel
takes one head dim for q, k and v, the paged kernel (P, ps, Hkv, D) pages.
"""
from __future__ import annotations

import contextlib
import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import mamba_scan as MS
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as PA
from repro_torch.models import layers as L
from repro_torch.models.layers import apply_rope, rms_norm
from repro_torch.models.params import ParamMeta, dense
from repro_torch.sharding import spmd
from repro_torch.sharding.plan import Spec

NEG_INF = -1e30

#: the kernels the model calls: flash and paged attention here, the Mamba2
#: scan in ``models/ssm.py`` (the wrappers of ``kernels.ops``, which launch
#: the kernel on a CUDA tensor and run the plain version on a CPU one);
#: :func:`plain_kernels` swaps in the plain versions, so that a run on the
#: card can be held against them
KERNELS = {"flash": ops.flash_attention_bh,
           "paged": ops.paged_attention_decode,
           "mamba": ops.mamba_scan_b}


@contextlib.contextmanager
def plain_kernels():
    """Within the block, the model runs the kernels' plain versions on
    every device."""
    saved = dict(KERNELS)
    KERNELS.update(flash=FA.flash_attention_ref,
                   paged=PA.paged_attention_ref,
                   mamba=MS.mamba_scan_ref)
    try:
        yield
    finally:
        KERNELS.update(saved)


def decode_positions(pos, B: int, S: int, device) -> torch.Tensor:
    """Absolute query positions ``(B, S)`` int32 from a scalar or ``(B,)``
    pos."""
    p = torch.as_tensor(pos, dtype=torch.int32, device=device)
    if p.dim() == 0:
        p = p.expand(B)
    return p[:, None] + torch.arange(S, dtype=torch.int32, device=device)[None]


def _chunk_index(start, S: int, T: int) -> torch.Tensor:
    """Indices ``(B, S)`` that a width-S write at per-row ``start`` covers
    in a length-T row, with the start clamped to [0, T - S] as XLA's
    ``dynamic_update_slice`` clamps it: a chunk that would run past the end
    lands shifted back instead. The clamp reproduces the reference's
    ``_row_update`` fault of the full cache; a ring wraps instead
    (:func:`_ring_index`), and the two must not share it."""
    if S > T:
        raise ValueError(f"a chunk of {S} tokens does not fit a {T}-entry "
                         f"cache row")
    s0 = start.long().clamp(0, T - S)
    return s0[:, None] + torch.arange(S, device=start.device)[None]


def _row_update(arr, new, start):
    """Write ``new`` (B, S, ...) into ``arr`` (B, T, ...) at per-row offsets,
    in place (the start clamped as the reference's update clamps it)."""
    B, S = new.shape[:2]
    t = _chunk_index(start, S, arr.shape[1])
    rows = torch.arange(B, device=arr.device)[:, None].expand(B, S)
    arr[rows, t] = new.to(arr.dtype)
    return arr


def _ring_index(start, S: int, T: int) -> torch.Tensor:
    """Indices ``(B, S)`` that a width-S chunk at per-row ``start`` covers
    in a T-entry ring: ``(start + j) % T``, wrapping index-wise. One chunk
    may not lap the ring (the indices must stay unique)."""
    if S > T:
        raise ValueError(f"chunk of {S} tokens would lap the {T}-entry ring")
    return (start.long()[:, None]
            + torch.arange(S, device=start.device)[None]) % T


def _keep(n_valid, B: int, S: int, device) -> torch.Tensor:
    """(B, S) bool: the real tokens of each row (all, without n_valid)."""
    if n_valid is None:
        return torch.ones((B, S), dtype=torch.bool, device=device)
    nv = torch.as_tensor(n_valid, dtype=torch.int32, device=device)
    return torch.arange(S, device=device)[None] < nv[:, None]


def _masked_put(arr, index, new, keep=None):
    """``arr[index] = new`` where ``keep`` (everywhere when None), the old
    value elsewhere, in place: ``index`` a tuple of (B, S) index tensors,
    new (B, S, ...)."""
    new = new.to(arr.dtype)
    if keep is not None:
        k = keep.reshape(keep.shape + (1,) * (new.dim() - 2))
        new = torch.where(k, new, arr[index])
    arr[index] = new


def _ring_scatter(arr, new, start, n_valid):
    """Write ``new`` (B,S,...) into ring ``arr`` (B,T,...) at per-row
    offsets modulo T, in place. Unlike :func:`_row_update` (which clamps
    ``start``, so a chunk touching the end lands shifted), entries wrap
    index-wise, and rows' padded tails (past ``n_valid``) are masked out so
    they never overwrite live window entries. Requires ``S <= T``."""
    B, S = new.shape[:2]
    t = _ring_index(start, S, arr.shape[1])
    rows = torch.arange(B, device=arr.device)[:, None].expand(B, S)
    _masked_put(arr, (rows, t), new, _keep(n_valid, B, S, arr.device))
    return arr


def _new_pos_ids(positions, n_valid):
    """Position ids to record for an appended chunk: the absolute position,
    or -1 (invalid) past each row's ``n_valid`` real tokens."""
    if n_valid is None:
        return positions
    keep = _keep(n_valid, *positions.shape, positions.device)
    return torch.where(keep, positions, torch.full_like(positions, -1))


# =============================================================================
# GQA
# =============================================================================

def gqa_params(cfg: ModelConfig, cross: bool = False, *, plan):
    d, dh = cfg.d_model, cfg.head_dim
    h, hkv = plan.num_heads, plan.num_kv_heads
    p = {
        "wq": ParamMeta((d, h, dh), ("embed", "heads", None), fan_in=d),
        "wk": ParamMeta((d, hkv, dh), ("embed", "kv_heads", None), fan_in=d),
        "wv": ParamMeta((d, hkv, dh), ("embed", "kv_heads", None), fan_in=d),
        "wo": ParamMeta((h, dh, d), ("heads", None, "embed"), fan_in=h * dh),
    }
    if cfg.qk_norm:
        p["q_norm"] = ParamMeta((dh,), (None,), init="ones")
        p["k_norm"] = ParamMeta((dh,), (None,), init="ones")
    if cross:
        p["gate"] = ParamMeta((1,), (None,), init="zeros")
    return p


def _proj(x, w):
    """x (B, S, d) @ w (d, h, dh) -> (B, S, h, dh)."""
    return (x @ w.reshape(w.shape[0], -1)).reshape(
        *x.shape[:-1], w.shape[1], w.shape[2])


def _qkv(p, x, kv_x, cfg: ModelConfig, cols: bool = False):
    """The projections; ``cols``: the qk-norms' means a column at a time
    (``L.by_column``)."""
    q = _proj(x, p["wq"])
    k = _proj(kv_x, p["wk"])
    v = _proj(kv_x, p["wv"])
    if cfg.qk_norm:
        # the scales are whole on every rank and read by its heads alone:
        # inside an spmd.region their gradients sum over the model axis
        q = rms_norm(q, spmd.enter(p["q_norm"]), cfg.norm_eps, cols)
        k = rms_norm(k, spmd.enter(p["k_norm"]), cfg.norm_eps, cols)
    return L.tap("q", q), L.tap("k", k), L.tap("v", v)


def _o_proj(o, wo):
    """o (B, S, H, D) @ wo (H, D, d) -> (B, S, d)."""
    return o.reshape(*o.shape[:2], -1) @ wo.reshape(-1, wo.shape[-1])


def _out(o, wo):
    """:func:`_o_proj`, recorded on the tape."""
    return L.tap("o", _o_proj(o, wo))


def _sdpa(q, k, v, mask):
    """q (B,S,H,D), k/v (B,T,Hkv,D), mask (B,1,1,S,T) or None -> (B,S,H,D).

    Scores in float32 (the reference asks its dot for a float32 result;
    here the inputs are widened, which gives the same products), softmax in
    float32, weights cast to v's dtype before the product with v."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, S, Hkv, H // Hkv, D).float()
    scores = torch.einsum("bshgd,bthd->bhgst", qg, k.float())
    scores = scores / math.sqrt(D)
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    o = torch.einsum("bhgst,bthd->bshgd", w, v)
    return o.reshape(B, S, H, v.shape[-1])


def causal_mask(S: int, T: int, q_offset, window: int = 0, device=None):
    """(1,1,1,S,T) bool; query i attends key j iff j <= i (+ window)."""
    qi = q_offset + torch.arange(S, device=device)[:, None]
    kj = torch.arange(T, device=device)[None, :]
    m = kj <= qi
    if window:
        m &= kj > qi - window
    return m[None, None, None]


def flash_fits(q, k, v) -> bool:
    """Whether the flash kernel takes these shapes: q, k and v of one head
    dim, and that dim in ``flash_attention.HEAD_DIMS``."""
    return q.shape[-1] == k.shape[-1] == v.shape[-1] and \
        q.shape[-1] in FA.HEAD_DIMS


def cross_attend(q, k, v):
    """Attention with no mask: q (B, S, H, D) over k, v (B, T, Hkv, D) (a
    cross step, or an encoder's self-attention): the flash kernel with
    ``causal=False`` where it takes the shapes, else :func:`_sdpa`."""
    if flash_fits(q, k, v):
        return KERNELS["flash"](q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=False)
    return _sdpa(q, k, v, None)


def gqa_apply(p, x, cfg: ModelConfig, positions=None, kv_x=None,
              cross: bool = False, causal: bool = True):
    """Train/prefill path. x (B,S,D). Returns (out, (k, v)) — k, v for
    cache seeding. On the flash-attention kernel (its plain version on the
    CPU), where the head dim fits it (:func:`flash_fits`): causal
    self-attention without a window (S == T), and, with ``causal=False``,
    non-causal and cross-attention (no mask, any S and T). Windows keep
    :func:`_sdpa`. Inside an ``spmd.region`` the weights are this rank's
    heads, and the output projection's partial sums add up over the model
    axis. Under sequence parallelism x is this rank's sequence shard: it
    is gathered on the way in (so S and the positions are the whole
    sequence's) and the output is scattered back to the shard, which the
    cross gate then multiplies (its gradient a partial sum:
    ``spmd.seq_param``); ``kv_x`` (the image embeddings, the encoder
    output) is whole and enters."""
    x = spmd.enter_seq(x)
    B, S, _ = x.shape
    kv_x = x if kv_x is None else spmd.enter(kv_x)
    q, k, v = _qkv(p, x, kv_x, cfg)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None]
    if not cross:
        q = apply_rope(q, positions, cfg)
        k = apply_rope(k, positions, cfg)
    if cross or not causal:
        o = cross_attend(q, k, v)
    elif not cfg.sliding_window and S == k.shape[1] and flash_fits(q, k, v):
        o = KERNELS["flash"](q.contiguous(), k.contiguous(), v.contiguous(),
                             causal=True)
    else:
        o = _sdpa(q, k, v, causal_mask(S, k.shape[1], 0, cfg.sliding_window,
                                       x.device))
    o = spmd.leave_seq(_out(o, p["wo"]))
    if cross:
        o = o * torch.tanh(spmd.seq_param(p["gate"]))
    return o, (k, v)


# --- decode ------------------------------------------------------------------

def cache_len(cfg: ModelConfig, max_len: int) -> int:
    """Entries per slot of the decode cache: the ring ``min(max_len,
    window)`` for a sliding-window model, else ``max_len``."""
    return min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len


def gqa_cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device=None, *, plan):
    T = cache_len(cfg, max_len)
    hkv, dh = plan.num_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, T, hkv, dh), dtype=dtype, device=device),
        "v": torch.zeros((batch, T, hkv, dh), dtype=dtype, device=device),
        "pos_ids": torch.full((batch, T), -1, dtype=torch.int32,
                              device=device),
    }


def gqa_cache_spec(plan, seq_axis=None):
    b = plan.batch_axes
    kvh = plan.rules.get("kv_heads")
    return {"k": Spec(b, seq_axis, kvh, None),
            "v": Spec(b, seq_axis, kvh, None), "pos_ids": Spec(b, seq_axis)}


def _win_mask(entry_pos, positions, window: int):
    """(B, S, T') validity of entries with ids ``entry_pos`` (B, T') for the
    queries at ``positions`` (B, S)."""
    e = entry_pos[:, None, :]
    p = positions[..., None]
    return (e >= 0) & (e <= p) & (e > p - window)


def _paged_write(cache, block_table, t, news, keep=None):
    """Write a chunk's entries ``news`` ({name: (B, S, ...)}) at the logical
    indices ``t`` (B, S) of each slot's table, in place, where ``keep``
    (everywhere when None)."""
    ps = cache["pos_ids"].shape[1]
    page = torch.gather(block_table.long(), 1, t // ps)
    for name, new in news.items():
        _masked_put(cache[name], (page, t % ps), new, keep)


def _unseen_rows(o, cache, table, block_table, t, v_new, positions, w,
                 null_page, slots=None):
    """The paged kernel's output ``o`` (B, S, H, D) with each row that sees
    no key (an idle slot's: n_valid 0 and no entry of its own) set to what
    the reference's paged step gives it. The kernel writes such a row as an
    exact 0; the reference gathers the slot's logical cache and takes a
    softmax whose mask value is finite, so the row averages the slot's
    entries uniformly: with a window the ``T`` entries of its ring before
    the write and the chunk's ``S`` rows, without one the ``T`` entries
    after the chunk's (clamped) write. Pages the slot does not own read as
    the reference's fill, zeros. ``table``: what the kernel read (the ring,
    or the ring and the scratch pages); ``t`` (B, S): the chunk's logical
    indices. Only an MoE model needs it: there the row's routes take
    expert capacity from real tokens (``models/moe``). ``slots`` (host
    ints; None: every slot): the only slots whose rows may see no key; the
    others' rows are left as they are, and an empty list costs nothing."""
    if slots is None:
        return _uniform_rows(o, cache, table, block_table, t, v_new,
                             positions, w, null_page)
    if len(slots) == 0:
        return o
    sl = torch.as_tensor(slots, dtype=torch.long, device=o.device)
    o[sl] = _uniform_rows(o[sl], cache, table[sl], block_table[sl], t[sl],
                          v_new[sl], positions[sl], w, null_page)
    return o


def _uniform_rows(o, cache, table, block_table, t, v_new, positions, w,
                  null_page):
    """``_unseen_rows`` over every slot of its arguments."""
    B, S, H, D = o.shape
    ps = cache["pos_ids"].shape[1]
    ids = cache["pos_ids"][table.long()].reshape(B, 1, -1)
    p = positions[..., None]
    seen = (ids >= 0) & (ids <= p)
    if w:
        seen &= ids > p - w
    unseen = ~seen.any(-1)  # (B, S)
    bt = block_table.long()
    v = cache["v"][bt].reshape(B, bt.shape[1] * ps, *v_new.shape[2:])
    if null_page is not None:
        own = (bt != null_page).repeat_interleave(ps, dim=1)
        v = v * own[..., None, None].to(v.dtype)
    v_new = v_new.to(v.dtype)
    if w:
        v = torch.cat([v, v_new], dim=1)
    else:
        rows = torch.arange(B, device=v.device)[:, None].expand(B, S)
        v = v.index_put((rows, t), v_new)
    wt = torch.full((v.shape[1],), 1.0 / v.shape[1], dtype=torch.float32,
                    device=v.device).to(v.dtype)
    avg = torch.einsum("bthd,t->bhd", v, wt)  # (B, Hkv, D)
    avg = avg.repeat_interleave(H // avg.shape[1], dim=1)[:, None]
    return torch.where(unseen[..., None, None], avg.to(o.dtype), o)


def gqa_decode(p, x, cache, pos, cfg: ModelConfig, n_valid=None,
               block_table=None, scratch_table=None, null_page=None,
               idle_slots=None, cols: bool = False):
    """Ragged decode/extend. x (B,S,D); pos: scalar or (B,) per-slot
    position. Appends S new tokens per row at that row's own offset (ring-
    modded for sliding-window caches), in place; ``n_valid`` (B,) marks how
    many of the S tokens are real per row (padded tails record
    ``pos_id = -1``).

    A sliding-window ring: token j of the chunk evicts the entry at
    ``(pos + j) % T``, which for S > 1 may still be inside token i < j's
    window, so the queries attend over the PRE-update ring plus the chunk's
    own K/V under the window mask, and the chunk is then ring-scattered
    (wrapped, padded tails masked off), as the reference does.

    With ``block_table`` (B, n_pages) int32, ``cache`` is one layer of the
    paged pool, ``k``/``v`` (P, page_size, Hkv, D) and ``pos_ids``
    (P, page_size): the chunk's logical index ``t`` lands at
    ``(bt[b, t // ps], t % ps)``, and the paged-attention kernel reads the
    pool directly, the (B, S) queries as one chunk per slot with the slot's
    table and each row's own position: the reference's mask over the
    freshly written cache, without gathering a logical cache or scattering
    it back. Without a window, ``t`` is the contiguous write's (the start
    clamped) and tails that map to unallocated entries land on the inert
    null page. With one, ``t`` wraps the ring of ``n_pages * page_size``
    entries and the kernel takes the window bound. Where the cache's owner
    gives a ``scratch_table`` (B, n_scratch) (``PagedKVCacheManager`` does
    for a ring as long as the window, on which an evicted entry can still
    be in a query's window), a chunk of S > 1 is first written to the
    slot's scratch pages, the kernel reads ``[ring pages | scratch pages]``
    (the pre-update ring plus the chunk), and the chunk is then scattered
    into the ring; such a chunk without scratch pages raises. A decode row
    (S = 1) evicts only ``pos - window``, which its window leaves out, so
    it is written first.

    ``idle_slots`` (host ints; None: every slot): the slots with no real
    token in the chunk, the only ones whose rows an MoE model's paged step
    may have to repair (``_unseen_rows``).

    ``cols``: the qk-norms' means run a column at a time
    (``L.by_column``), so each row of a short chunk takes its decode row's
    arithmetic; the paged kernel scores such a chunk so by itself."""
    B, S, _ = x.shape
    q, k_new, v_new = _qkv(p, x, x, cfg, cols)
    positions = decode_positions(pos, B, S, x.device)  # (B,S)
    q = apply_rope(q, positions, cfg)
    k_new = apply_rope(k_new, positions, cfg)
    ids = _new_pos_ids(positions, n_valid)
    news = {"k": k_new, "v": v_new, "pos_ids": ids}
    w = cfg.sliding_window
    if block_table is None:
        T = cache["k"].shape[1]
        start = positions[:, 0] % T  # ring for SWA; == pos when T == max_len
        if w:
            mask = torch.cat([_win_mask(cache["pos_ids"], positions, w),
                              _win_mask(ids, positions, w)], dim=-1)
            o = _sdpa(q, torch.cat([cache["k"], k_new.to(cache["k"].dtype)],
                                   dim=1),
                      torch.cat([cache["v"], v_new.to(cache["v"].dtype)],
                                dim=1), mask[:, None, None])
            for name, new in news.items():
                _ring_scatter(cache[name], new, start, n_valid)
        else:
            for name, new in news.items():
                _row_update(cache[name], new, start)
            pos_ids = cache["pos_ids"]
            valid = (pos_ids >= 0)[:, None, :] & \
                (pos_ids[:, None, :] <= positions[..., None])
            o = _sdpa(q, cache["k"], cache["v"], valid[:, None, None])
        return _out(L.tap("attn", o), p["wo"]), cache
    ps = cache["k"].shape[1]
    T = block_table.shape[1] * ps
    table = block_table
    if not w:
        t = _chunk_index(positions[:, 0] % T, S, T)  # (B,S)
        _paged_write(cache, block_table, t, news)
    else:
        t = _ring_index(positions[:, 0] % T, S, T)
        keep = ids >= 0
        if S > 1 and scratch_table is None and T >= w:
            raise ValueError(f"a chunk of {S} tokens on a wrapping ring "
                             f"needs scratch pages for it")
        if S > 1 and scratch_table is not None:
            # the cache's owner gave scratch pages: its ring can wrap
            # under the chunk, which may evict entries it still sees
            if S > scratch_table.shape[1] * ps:
                raise ValueError(f"a chunk of {S} tokens does not fit "
                                 f"{tuple(scratch_table.shape)} scratch "
                                 f"pages of {ps}")
            cache["pos_ids"][scratch_table.long()] = -1
            j = torch.arange(S, device=x.device)[None].expand(B, S)
            _paged_write(cache, scratch_table, j, news)
            table = torch.cat([block_table, scratch_table], dim=1)
        else:
            _paged_write(cache, block_table, t, news, keep)
    o = KERNELS["paged"](q.contiguous(), cache["k"], cache["v"],
                         cache["pos_ids"], table.contiguous(),
                         positions.contiguous(), window=w)
    if cfg.is_moe:
        # every row of a slot with a real token sees that token, unless the
        # chunk outruns the window
        slots = None if w and S > w else idle_slots
        o = _unseen_rows(o, cache, table, block_table, t, v_new, positions,
                         w, null_page, slots)
    if table is not block_table:
        _paged_write(cache, block_table, t, news, keep)
    return _out(L.tap("attn", o), p["wo"]), cache


def gqa_seed_cache(cache, kv, prefill_len: int, lengths=None):
    """Write prefill-time K/V into a zero decode cache, in place.

    ``lengths`` (B,) optionally marks per-row true prompt lengths for
    right-padded batched prefill: positions past a row's length record
    ``pos_id = -1`` so they stay invisible to the decode mask.

    A prefill longer than a sliding-window ring (S > T) keeps its last T
    entries and writes them from ring index 0, as the reference's does
    (``repro/models/attention.py:319-323``), though decode writes position
    p at ``p % T``: when S % T != 0 the first decode overwrites a live
    entry. The port reproduces that fault on purpose."""
    k, v = kv
    B, S = k.shape[:2]
    T = cache["k"].shape[1]
    pos = torch.arange(S, dtype=torch.int32, device=k.device)
    if S > T:  # the reference's tail branch, its ring offset as it is
        k, v, pos, S = k[:, S - T:], v[:, S - T:], pos[S - T:], T
    pos2 = pos[None].expand(B, S)
    if lengths is not None:
        ln = torch.as_tensor(lengths, dtype=torch.int32, device=k.device)
        pos2 = torch.where(pos2 < ln[:, None], pos2, torch.full_like(pos2, -1))
    cache["k"][:, :S] = k.to(cache["k"].dtype)
    cache["v"][:, :S] = v.to(cache["v"].dtype)
    cache["pos_ids"][:, :S] = pos2
    return cache


# =============================================================================
# MLA (deepseek-v2): low-rank compressed KV, absorbed decode
# =============================================================================

def mla_params(cfg: ModelConfig, plan):
    d, h = cfg.d_model, plan.num_heads
    nope, rope_d, vd = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                        cfg.v_head_dim)
    r = cfg.kv_lora_rank
    p = {
        "kv_down": dense(d, r + rope_d, "embed", None),
        "kv_norm": ParamMeta((r,), (None,), init="ones"),
        "k_up": ParamMeta((r, h, nope), (None, "heads", None), fan_in=r),
        "v_up": ParamMeta((r, h, vd), (None, "heads", None), fan_in=r),
        "wo": ParamMeta((h, vd, d), ("heads", None, "embed"), fan_in=h * vd),
    }
    if cfg.q_lora_rank:
        p["q_down"] = dense(d, cfg.q_lora_rank, "embed", None)
        p["q_norm"] = ParamMeta((cfg.q_lora_rank,), (None,), init="ones")
        p["q_up"] = ParamMeta((cfg.q_lora_rank, h, nope + rope_d),
                              (None, "heads", None), fan_in=cfg.q_lora_rank)
    else:
        p["q_up"] = ParamMeta((d, h, nope + rope_d), ("embed", "heads", None),
                              fan_in=d)
    return p


def _mla_q(p, x, cfg: ModelConfig, positions):
    """(q_nope (B,S,H,nope), q_rope (B,S,H,rope)), the rope part rotated;
    the input of ``q_up`` (the normed latent, or x) enters an
    ``spmd.region`` (:func:`mla_apply`)."""
    nope, rope_d = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    if cfg.q_lora_rank:
        cq = rms_norm(x @ p["q_down"], p["q_norm"], cfg.norm_eps)
        q = _proj(spmd.enter(cq), p["q_up"])
    else:
        q = _proj(spmd.enter(x), p["q_up"])
    return q[..., :nope], apply_rope(q[..., nope:], positions, cfg,
                                     dim=rope_d)


def _mla_ckv(p, x, cfg: ModelConfig, positions):
    """(c_kv (B,T,r) normed, k_rope (B,T,rope) rotated)."""
    r, rope_d = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    kvd = x @ p["kv_down"]
    c_kv = rms_norm(kvd[..., :r], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(kvd[..., r:][:, :, None, :], positions, cfg,
                        dim=rope_d)[:, :, 0]
    return c_kv, k_rope


def mla_apply(p, x, cfg: ModelConfig, positions=None):
    """Train/prefill: the compressed KV expanded per head, causal
    :func:`_sdpa` (q/k heads of nope + rope, v heads of v_head_dim); returns
    (out, (c_kv, k_rope)) for cache seeding. Inside an ``spmd.region``
    ``q_up``, ``k_up``, ``v_up`` and ``wo`` are this rank's heads; the
    latents of the whole ``q_down`` and ``kv_down`` (after their norms) and
    ``k_rope``, which every rank's heads read, enter the region there (so
    the gradients of the down projections, their norms and x sum over the
    model axis once), and the output projection's partial sums add up over
    the model axis. Without ``q_lora_rank`` x itself enters ``q_up``.

    Under sequence parallelism x is this rank's sequence shard, and it is
    gathered before the down projections (``spmd.whole_seq``), which run
    on the whole sequence on every rank as without the flag: the latents
    enter as above, so the gradient that reaches x is whole and the
    gather's backward keeps this rank's chunk; the positions and the rope
    are the whole sequence's. The output is scattered back to the shard
    (``spmd.leave_seq``)."""
    x = spmd.whole_seq(x)
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None]
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    c_kv, k_rope = _mla_ckv(p, x, cfg, positions)
    c_in, k_rope_in = spmd.enter(c_kv), spmd.enter(k_rope)
    k_nope = _proj(c_in, p["k_up"])
    v = _proj(c_in, p["v_up"])
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope_in[:, :, None, :].expand(
        *k_nope.shape[:3], k_rope.shape[-1])], -1)
    o = _sdpa(q, k, v, causal_mask(S, S, 0, device=x.device))
    return spmd.leave_seq(_out(o, p["wo"])), (c_kv, k_rope)


def mla_cache_spec(plan, seq_axis=None):
    b = plan.batch_axes
    return {"c_kv": Spec(b, seq_axis, None), "k_rope": Spec(b, seq_axis, None),
            "pos_ids": Spec(b, seq_axis)}


def mla_cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device=None):
    return {
        "c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_head_dim),
                              dtype=dtype, device=device),
        "pos_ids": torch.full((batch, max_len), -1, dtype=torch.int32,
                              device=device),
    }


def _mla_attend(p, q_nope, q_rope, positions, c_kv, k_rope, pos_ids,
                cfg: ModelConfig):
    """The absorbed attention of queries at ``positions`` (B, S) over a
    slot's compressed cache rows c_kv (B, T, r), k_rope (B, T, rope) with
    ids ``pos_ids`` (B, T) -> (B, S, H, v_head_dim), before the output
    projection. Scores in float32 (the inputs
    widened, as :func:`_sdpa` does), weights cast to the compute dtype."""
    dt = q_nope.dtype
    q_c = torch.einsum("bshk,rhk->bshr", q_nope, p["k_up"])
    scores = (torch.einsum("bshr,btr->bhst", q_c.float(), c_kv.float())
              + torch.einsum("bshk,btk->bhst", q_rope.float(),
                             k_rope.float()))
    scores = scores / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    valid = (pos_ids >= 0)[:, None, :] & \
        (pos_ids[:, None, :] <= positions[..., None])  # (B,S,T)
    scores = torch.where(valid[:, None], scores,
                         torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1).to(dt)
    ctx_c = torch.einsum("bhst,btr->bshr", w, c_kv.to(dt))
    return torch.einsum("bshr,rhk->bshk", ctx_c, p["v_up"])


def mla_decode(p, x, cache, pos, cfg: ModelConfig, n_valid=None,
               block_table=None, null_page=None, cols: bool = False):
    """Absorbed decode, ragged like :func:`gqa_decode`: ``pos`` scalar or
    (B,), S >= 1, each row's chunk written at its own offset (the start
    clamped as the reference's ``_row_update`` clamps it; a full-length
    cache, no ring), in place; padded tails record ``pos_id = -1``.

    With ``block_table`` (B, n_pages), ``cache`` is one layer of the page
    pool, ``c_kv`` (P, ps, r), ``k_rope`` (P, ps, rope), ``pos_ids``
    (P, ps), and the cache's owner names its ``null_page``, the target of
    every unallocated table entry. As the reference's paged step does, the
    attention reads each slot's rows through its table (a copy), with the
    chunk written into them, and the chunk then lands in the pages at
    ``(bt[b, t // ps], t % ps)`` except on the null page, which stays zero
    and invalid: an unallocated entry reads as the reference's refilled
    null page, which a row that sees nothing (an idle slot) averages.

    ``cols`` (a chunk of 2..16 rows, ``L.by_column``): the projections and
    the attention run a column at a time, so that each row of a
    speculative verify takes its decode row's arithmetic (the later rows
    of the chunk are in the cache, masked)."""
    B, S, _ = x.shape
    positions = decode_positions(pos, B, S, x.device)  # (B,S)
    xs = L.columns(x, cols)
    ps_ = [positions[:, j:j + 1] for j in range(S)] if cols else [positions]
    qs = [_mla_q(p, xj, cfg, pj) for xj, pj in zip(xs, ps_)]
    kvs = [_mla_ckv(p, xj, cfg, pj) for xj, pj in zip(xs, ps_)]
    news = {"c_kv": L.join([c for c, _ in kvs]),
            "k_rope": L.join([k for _, k in kvs]),
            "pos_ids": _new_pos_ids(positions, n_valid)}
    if block_table is None:
        for name, new in news.items():
            _row_update(cache[name], new, positions[:, 0])
        rows = cache
    else:
        ps = cache["pos_ids"].shape[1]
        T = block_table.shape[1] * ps
        bt = block_table.long()
        rows = {name: leaf[bt].reshape(B, T, *leaf.shape[2:])
                for name, leaf in cache.items()}
        for name, new in news.items():
            _row_update(rows[name], new, positions[:, 0])
        t = _chunk_index(positions[:, 0], S, T)
        if null_page is None:
            raise ValueError("a paged MLA step needs the pool's null page")
        owned = torch.gather(bt, 1, t // ps) != null_page
        _paged_write(cache, block_table, t, news, owned)
    os_ = [_mla_attend(p, qn, qr, pj, rows["c_kv"], rows["k_rope"],
                       rows["pos_ids"], cfg) for (qn, qr), pj in zip(qs, ps_)]
    L.tap("attn", L.join(os_))
    return L.tap("o", L.join([_o_proj(o, p["wo"]) for o in os_])), cache


def mla_seed_cache(cache, kv, prefill_len: int, lengths=None):
    """Write prefill-time (c_kv, k_rope) into a zero decode cache, in
    place; ``lengths`` (B,) as in :func:`gqa_seed_cache`."""
    c_kv, k_rope = kv
    B, S = c_kv.shape[:2]
    pos2 = torch.arange(S, dtype=torch.int32, device=c_kv.device)[None] \
        .expand(B, S)
    if lengths is not None:
        ln = torch.as_tensor(lengths, dtype=torch.int32, device=c_kv.device)
        pos2 = torch.where(pos2 < ln[:, None], pos2, torch.full_like(pos2, -1))
    cache["c_kv"][:, :S] = c_kv.to(cache["c_kv"].dtype)
    cache["k_rope"][:, :S] = k_rope.to(cache["k_rope"].dtype)
    cache["pos_ids"][:, :S] = pos2
    return cache
