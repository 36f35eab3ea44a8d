"""Paged attention over a block-table page pool: the Hopper kernel and its
plain version.

Replaces the TPU kernel ``repro/kernels/paged_attention.py::paged_attention``
(and its oracle ``repro/kernels/ref.py::paged_attention_ref``). Each of R
query rows attends the KV cache that its block-table row names as
non-contiguous physical pages of a ``(P, page_size, Hkv, D)`` pool; entry
``t`` of a page is visible to a row at position ``pos`` iff

    0 <= ids[page, t] <= pos   (and ids > pos - window when window > 0)

so the permanently invalid null page (ids -1), a row disabled with
``pos = -1`` and ragged extends all fall out of one rule. A fully masked row
gives exact zeros (the ``p *= valid`` of the TPU kernel), never mean(v).
GQA is handled inside: query head ``h`` reads kv head ``h // (H / Hkv)``.

The serving tier's paged step flattens a ``(B, S)`` chunk to ``B * S`` rows,
each with its slot's block-table row and its own absolute position, which is
the reference's decode mask over the freshly written cache.

The kernel (``csrc/paged_attention.cu``) is bound by bytes: every page a
row's table names must be read once, a few hundred bytes of K and V per
head and entry against two multiply-adds per element. One block per (row,
kv head) walks the row's pages in order, skips a page none of whose entries
the row may see (the null page, pages past a short row's position) before
loading its K and V, and keeps the running max, denominator and
accumulator of its ``G = H / Hkv`` query heads (one warp each) in float32.
A flattened extend re-reads each page once per row of the chunk; the bound
counts each distinct page once, so that gap shows in the timing.

``paged_attention`` dispatches on q's device: the plain version for a CPU
tensor, the kernel for a CUDA tensor (or an error).
``paged_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

_KERNEL = "paged_attention"
NEG_INF = -1e30
WARP = 32  # keys scored together: one lane each
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def warp_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (32 lanes) in the order of the kernel's
    butterfly of shuffles: lane i adds lane i ^ 16, then i ^ 8, ... i ^ 1.
    Every lane ends with the same value (the additions only commute), the
    one returned."""
    for o in (16, 8, 4, 2, 1):
        x = x[..., :o] + x[..., o:2 * o]
    return x[..., 0]


def paged_attention_ref(q, k_pool, v_pool, ids_pool, block_table, pos, *,
                        window: int = 0):
    """The plain version: the kernel's arithmetic, one operation at a time,
    over all rows at once. q (R, H, D) -> (R, H, D) in q's dtype.

    Each row walks its block-table row in order with a running max ``m``,
    denominator ``l`` and accumulator in float32. On a page, up to 32 keys
    at a time: a key's score is its dot product with the query summed over
    d in order, divided by sqrt(D); a hidden key (``ids`` outside
    [0, pos], or not above pos - window) scores NEG_INF and weighs exactly
    0; ``l = l * corr + (the butterfly sum of the weights)`` and the
    accumulator is rescaled by ``corr = exp(m - m_new)``, then takes the
    keys' weighted rows of v one after another. The output is
    ``acc / max(l, 1e-30)``, so a row that sees nothing is exactly zero.
    Pages that no row may see are skipped (for a row they would change
    nothing). Every step rounds as the kernel's does (it is built without
    fused multiply-adds), so on the card the two agree bit for bit.

    This is the reference's oracle (gather the pages, masked softmax in
    float32, the product with v) up to float32 rounding; with bfloat16
    inputs the reference's ``_sdpa`` also rounds the weights to bfloat16
    before the product with v, which the TPU kernel, this kernel and this
    version do not."""
    R, H, D = q.shape
    ps, Hkv = k_pool.shape[1], k_pool.shape[2]
    G = H // Hkv
    heads = torch.arange(H, device=q.device) // G  # kv head of each head
    bt = block_table.long()
    p_r = pos.long()[:, None, None]  # (R, 1, 1)
    # a tensor, not a Python number: PyTorch turns a division by a number
    # into a product with its reciprocal, which rounds differently
    sqrt_d = torch.tensor(math.sqrt(D), dtype=torch.float32, device=q.device)
    qf = q.float()
    m = torch.full((R, H), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((R, H), dtype=torch.float32, device=q.device)
    acc = torch.zeros((R, H, D), dtype=torch.float32, device=q.device)
    ids_all = ids_pool[bt].long()  # (R, n, ps)
    seen = (ids_all >= 0) & (ids_all <= p_r)
    if window > 0:
        seen &= ids_all > p_r - window
    for j in seen.any(-1).any(0).nonzero().flatten().tolist():
        page = bt[:, j]
        kp = k_pool[page][:, :, heads].float()  # (R, ps, H, D)
        vp = v_pool[page][:, :, heads].float()
        for c in range(0, ps, WARP):
            nt = min(WARP, ps - c)
            vis = seen[:, j, c:c + nt][:, None, :].expand(R, H, nt)
            dot = torch.zeros((R, H, nt), dtype=torch.float32,
                              device=q.device)
            for d in range(D):
                dot = dot + qf[:, :, d, None] * kp[:, c:c + nt, :, d
                                                   ].transpose(1, 2)
            s = torch.where(vis, dot / sqrt_d, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.where(vis, torch.exp(s - m_new[..., None]), 0.0)
            corr = torch.exp(m - m_new)
            lanes = torch.nn.functional.pad(p, (0, WARP - nt))
            l = l * corr + warp_sum(lanes)
            acc = acc * corr[..., None]
            for t in range(nt):
                acc = acc + p[..., t, None] * vp[:, c + t]
            m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build
    lib = _build.load(_KERNEL)
    lib.paged_attention_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    lib.paged_attention_launch.restype = ctypes.c_int
    return lib


def smem_bytes(ps: int, G: int, D: int) -> int:
    """Shared memory of one block: K (padded rows) and V of one page for one
    kv head, the group's queries and the page's ids."""
    return 4 * (ps * (D + 1) + ps * D + G * D + ps)


def check_inputs(q, k_pool, v_pool, ids_pool, block_table, pos):
    """Validate the kernel's inputs; return (R, H, D, P, ps, Hkv, n)."""
    if q.dim() != 3 or k_pool.dim() != 4:
        raise ValueError("q must be (R, H, D) and the pools (P, ps, Hkv, D)")
    R, H, D = q.shape
    P, ps, Hkv, _ = k_pool.shape
    n = block_table.shape[1] if block_table.dim() == 2 else -1
    for x, name, dtype, shape in (
            (q, "q", q.dtype, (R, H, D)),
            (k_pool, "k_pool", q.dtype, (P, ps, Hkv, D)),
            (v_pool, "v_pool", q.dtype, (P, ps, Hkv, D)),
            (ids_pool, "ids_pool", torch.int32, (P, ps)),
            (block_table, "block_table", torch.int32, (R, n)),
            (pos, "pos", torch.int32, (R,))):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {dtype} of shape {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPES:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"{H} query heads do not group over {Hkv} kv heads")
    G = H // Hkv
    if G > 32 or D > 128 or ps < 1:
        raise ValueError(f"the kernel takes at most 32 query heads per kv "
                         f"head and head_dim <= 128 (G={G}, D={D})")
    if smem_bytes(ps, G, D) > 48 * 1024:
        raise ValueError(f"page_size {ps} with head_dim {D} needs more than "
                         f"48 KB of shared memory per block")
    if max(P * ps * Hkv * D, R * H * D, R * n) >= 2 ** 31:
        raise ValueError("each tensor must hold fewer than 2^31 elements")
    return R, H, D, P, ps, Hkv, n


def paged_attention(q, k_pool, v_pool, ids_pool, block_table, pos, *,
                    window: int = 0) -> torch.Tensor:
    """q (R, H, D), k/v pools (P, ps, Hkv, D) float32 or bfloat16 (q's
    dtype), ids_pool (P, ps), block_table (R, n_pages) and pos (R,) int32
    -> (R, H, D) in q's dtype. Block-table entries name pages in [0, P)."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, ids_pool, block_table,
                                   pos, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on CPU or CUDA tensors, "
                         f"not {q.device}")
    R, H, D, P, ps, Hkv, n = check_inputs(q, k_pool, v_pool, ids_pool,
                                          block_table, pos)
    out = torch.empty_like(q)
    if R == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().paged_attention_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            ids_pool.data_ptr(), block_table.data_ptr(), pos.data_ptr(),
            out.data_ptr(), R, H, Hkv, D, P, ps, n, int(window),
            _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"paged_attention launch failed: CUDA error {err}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
