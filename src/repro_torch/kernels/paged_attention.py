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

The queries come in one of two forms: rows, q (R, H, D) with
``block_table`` (R, n) and ``pos`` (R,), the reference's contract; or chunks,
q (B, S, H, D) with ``block_table`` (B, n) and ``pos`` (B, S): S query rows
per slot that share the slot's table, each at its own absolute position
(the serving tier's extend, the reference's decode mask over the freshly
written cache). Rows are the chunk form with S = 1.

The kernels (``csrc/paged_attention.cu``) put a tile of a slot's rows x the
G query heads of one kv head (at most 64 (row, head) pairs) in one block,
so each page a row of the tile may see is read once per tile and not once
per row; a block reads the table and the entries' ids a window at a time
with all its threads, so its shared memory does not grow with the table:
- decode (S = 1) and chunks of at most ``CHUNK_ROWS`` rows (a speculative
  verify) are bound by bytes (every visible page read once, two
  multiply-adds per element, G = 4 rows per kv head): split-K over pages on
  the CUDA cores, one block per (tile, kv head, slot, split of 16 table
  entries) writing a partial (m, l, acc) to float32 scratch, then a small
  kernel that combines the partials in split order; such a call makes these
  two CUDA launches;
- float32 chunks of more rows take the same CUDA-core kernel, each block
  folding every split's partial in split order itself (one launch);
- bfloat16 chunks of more rows (prefill chunks, bound by operations) take
  mma.sync tensor-core tiles of 64 keys through a cp.async ring.
Every row of the CUDA-core paths gets exactly its decode's arithmetic, in
either dtype: a chunk equals the decode of its rows bit for bit, so a
speculative verify scores drafts as greedy decoding does.

``paged_attention`` dispatches on q's device: the plain version for a CPU
tensor, the kernel for a CUDA tensor (or an error).
``paged_attention.launches`` counts calls that launched the kernels (one
per call, though a split-K call makes two CUDA launches).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels.grad import refuse_grad

_KERNEL = "paged_attention"
NEG_INF = -1e30
WARP = 32  # keys scored together: one lane each
SPLIT = 16  # table entries per split of the CUDA-core kernel
CHUNK_ROWS = 16  # chunks of at most this many rows take split-K
PAIRS = 64  # (row, head) pairs per block, at most
WIN = 1024  # table positions per window of the bf16 extend
STAGES = 3  # the bf16 extend's K/V ring
HEAD_DIMS = (16, 32, 64, 128)
SMEM_LIMIT = 232448  # bytes of shared memory a block may use (H100)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def warp_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (32 lanes) in the order of the kernel's
    butterfly of shuffles: lane i adds lane i ^ 16, then i ^ 8, ... i ^ 1.
    Every lane ends with the same value (the additions only commute), the
    one returned."""
    for o in (16, 8, 4, 2, 1):
        x = x[..., :o] + x[..., o:2 * o]
    return x[..., 0]


def _visible(ids, p, window: int):
    vis = (ids >= 0) & (ids <= p)
    if window > 0:
        vis &= ids > p - window
    return vis


def _table_ids(ids_pool, block_table):
    """(pages (rows, n) long, ids (rows, n, ps)): the table's pages, clamped
    into the pool, and their entries' ids, -1 where an entry names no page
    (outside [0, P))."""
    P = ids_pool.shape[0]
    bt = block_table.long()
    named = (bt >= 0) & (bt < P)
    pages = bt.clamp(0, P - 1)
    ids = torch.where(named[..., None], ids_pool[pages].long(), -1)
    return pages, ids


def fold(M, L, A, m, l, acc):
    """Fold a split's partial (m, l, acc) into the running (M, L, A) as the
    combine kernel does: M' = max(M, m), L = L a + l b and A = A a + acc b
    with a = exp(M - M'), b = exp(m - M')."""
    Mn = torch.maximum(M, m)
    a, b = torch.exp(M - Mn), torch.exp(m - Mn)
    return Mn, L * a + l * b, A * a[..., None] + acc * b[..., None]


def _decode_ref(q, k_pool, v_pool, ids_pool, block_table, pos, window):
    """The decode's arithmetic for rows q (R, H, D), block_table (R, n),
    pos (R,): split-K over the table in splits of SPLIT entries, each split
    walking its pages from m = NEG_INF, l = 0, acc = 0, then the partials
    folded in split order (:func:`fold`)."""
    R, H, D = q.shape
    ps, Hkv = k_pool.shape[1], k_pool.shape[2]
    heads = torch.arange(H, device=q.device) // (H // Hkv)
    pages, ids_all = _table_ids(ids_pool, block_table)  # (R, n), (R, n, ps)
    n = pages.shape[1]
    seen = _visible(ids_all, pos.long()[:, None, None], window)
    # a tensor, not a Python number: PyTorch turns a division by a number
    # into a product with its reciprocal, which rounds differently
    sqrt_d = torch.tensor(math.sqrt(D), dtype=torch.float32, device=q.device)
    qf = q.float()
    f32 = dict(dtype=torch.float32, device=q.device)
    M = torch.full((R, H), NEG_INF, **f32)
    L = torch.zeros((R, H), **f32)
    A = torch.zeros((R, H, D), **f32)
    live = seen.any(-1).any(0).tolist()  # (n,): some row sees the page
    for j0 in range(0, n, SPLIT):
        m = torch.full((R, H), NEG_INF, **f32)
        l = torch.zeros((R, H), **f32)
        acc = torch.zeros((R, H, D), **f32)
        for j in range(j0, min(n, j0 + SPLIT)):
            if not live[j]:  # for every row a step that changes nothing
                continue
            kp = k_pool[pages[:, j]][:, :, heads].float()  # (R, ps, H, D)
            vp = v_pool[pages[:, j]][:, :, heads].float()
            for c in range(0, ps, WARP):
                nt = min(WARP, ps - c)
                vis = seen[:, j, c:c + nt][:, None, :].expand(R, H, nt)
                dot = torch.zeros((R, H, nt), **f32)
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
        M, L, A = fold(M, L, A, m, l, acc)
    return A / torch.clamp(L, min=1e-30)[..., None]


def _extend_bf16_ref(q, k_pool, v_pool, ids_pool, block_table, pos, window):
    """The bf16 extend's arithmetic for chunks q (B, S, H, D): the slot's
    table read as one logical cache, its keys in tiles of 64 table
    positions through :func:`flash_attention.mma_tile_step` (a tile a pair
    cannot see changes nothing for it; tiles no row sees are skipped)."""
    B, S, H, D = q.shape
    ps, Hkv = k_pool.shape[1], k_pool.shape[2]
    heads = torch.arange(H, device=q.device) // (H // Hkv)
    pages, ids_all = _table_ids(ids_pool, block_table)
    n_keys = pages.shape[1] * ps
    pad = -n_keys % FA.TILE

    def logical(pool):  # (B, H, n_keys + pad, D) float32
        x = pool[pages].reshape(B, n_keys, Hkv, D)[:, :, heads].float()
        return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad)).transpose(1, 2)

    kl, vl = logical(k_pool), logical(v_pool)
    ids_l = torch.nn.functional.pad(ids_all.reshape(B, n_keys), (0, pad),
                                    value=-1)
    vis = _visible(ids_l[:, None, None, :], pos.long()[:, None, :, None],
                   window)  # (B, 1, S, keys)
    # (tiles,): some row sees an entry of the tile
    live = vis.reshape(-1, (n_keys + pad) // FA.TILE, FA.TILE).any(-1).any(
        0).tolist()
    scale = torch.tensor(FA.scale_log2(D), dtype=torch.float32,
                         device=q.device)
    f32 = dict(dtype=torch.float32, device=q.device)
    m = torch.full((B, H, S), NEG_INF, **f32)
    l = torch.zeros((B, H, S), **f32)
    acc = torch.zeros((B, H, S, D), **f32)
    qf = q.float().transpose(1, 2)
    for c in range(0, n_keys + pad, FA.TILE):
        if not live[c // FA.TILE]:  # for every row a step that changes nothing
            continue
        m, l, acc = FA.mma_tile_step(qf, kl[:, :, c:c + FA.TILE],
                                     vl[:, :, c:c + FA.TILE],
                                     vis[..., c:c + FA.TILE], scale, m, l,
                                     acc)
    return (acc / torch.clamp(l, min=1e-30)[..., None]).transpose(1, 2)


def paged_attention_ref(q, k_pool, v_pool, ids_pool, block_table, pos, *,
                        window: int = 0):
    """The plain version: the kernels' arithmetic, one operation at a time,
    over all rows at once. q (R, H, D) rows or (B, S, H, D) chunks -> the
    same shape in q's dtype.

    Rows, chunks of at most ``CHUNK_ROWS`` rows and float32 chunks take the
    decode's arithmetic over the chunk's rows: the table in splits of 16
    entries; in each split the pages in order from
    m = NEG_INF, l = 0, acc = 0, up to 32 keys at a time: a key's score is
    its dot product with the query summed over d in order, divided by
    sqrt(D); a hidden key (``ids`` outside [0, pos], or not above
    pos - window) scores NEG_INF and weighs exactly 0;
    ``l = l * corr + (the butterfly sum of the weights)`` and the
    accumulator is rescaled by ``corr = exp(m - m_new)``, then takes the
    keys' weighted rows of v one after another. The splits' partials are
    folded in order (:func:`fold`), and the output is
    ``acc / max(l, 1e-30)``, so a row that sees nothing is exactly zero.
    Pages no row may see are skipped (for a row they would change nothing).
    Every step rounds as the kernels do (built without fused multiply-adds),
    so on the card the two agree bit for bit.

    bfloat16 chunks of more rows take the tensor-core extend's tiles of 64
    keys (:func:`flash_attention.mma_tile_step`, the tensor cores' sums
    included), bit for bit too.

    This is the reference's oracle (gather the pages, masked softmax in
    float32, the product with v) up to float32 rounding."""
    rows = q.dim() == 3
    qc = q[:, None] if rows else q
    pc = pos[:, None] if rows else pos
    B, S, H, D = qc.shape
    if _route(S, q.dtype) == "mma":
        out = _extend_bf16_ref(qc, k_pool, v_pool, ids_pool, block_table, pc,
                               window)
    else:
        out = _decode_ref(qc.reshape(B * S, H, D), k_pool, v_pool, ids_pool,
                          block_table.repeat_interleave(S, dim=0),
                          pc.reshape(-1), window).reshape(B, S, H, D)
    out = out.to(q.dtype)
    return out[:, 0] if rows else out


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build
    lib = _build.load(_KERNEL)
    lib.paged_rows_launch.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 12 + [ctypes.c_void_p])
    lib.paged_rows_launch.restype = ctypes.c_int
    lib.paged_extend_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
        + [ctypes.c_float, ctypes.c_void_p])
    lib.paged_extend_launch.restype = ctypes.c_int
    return lib


def _route(S: int, dtype) -> str:
    """The kernel that chunks of S rows take: "split" (split-K on the CUDA
    cores), "fold" (the CUDA cores, splits folded in the block) or "mma"
    (the bf16 tensor-core extend)."""
    if S <= CHUNK_ROWS:
        return "split"
    return "mma" if dtype == torch.bfloat16 else "fold"


def tile_rows(S: int, G: int, route: str) -> int:
    """Chunk rows per block: as many as fill 64 (row, head) pairs (the
    CUDA-core kernel takes no more than the chunk has)."""
    return PAIRS // G if route == "mma" else min(S, PAIRS // G)


def smem_bytes(S: int, G: int, D: int, ps: int, elem: int) -> int:
    """Shared memory of one block of the kernel that chunks of S rows take
    (``csrc/paged_attention.cu``: rows_smem, extend_bf16_smem); it does not
    depend on the table's length."""
    route = _route(S, torch.float32 if elem == 4 else torch.bfloat16)
    if route == "mma":
        return (2 * (D + 8) * (64 + 2 * STAGES * FA.TILE)
                + 4 * (PAIRS + 2 * WIN + 2 * (WIN // FA.TILE) + 1))
    M = tile_rows(S, G, route) * G
    return (elem * 4 * ps * (D + 16 // elem) + 4 * M * D
            + 4 * (M + 2 * SPLIT + SPLIT * ps))


_SCRATCH: dict = {}


def _scratch(device, stream: int, numel: int) -> torch.Tensor:
    """A float32 buffer of at least ``numel`` elements for the split-K
    partials, one per (device, stream), grown as needed and kept: the
    partials live only between the two launches of one call, and calls on
    one stream run in order."""
    key = (device, stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < numel:
        buf = torch.empty(numel, dtype=torch.float32, device=device)
        _SCRATCH[key] = buf
    return buf


def check_inputs(q, k_pool, v_pool, ids_pool, block_table, pos):
    """Validate the kernel's inputs, rows or chunks; return
    (B, S, H, D, P, ps, Hkv, n) of the chunk form."""
    if q.dim() not in (3, 4) or k_pool.dim() != 4:
        raise ValueError("q must be (R, H, D) or (B, S, H, D) and the pools "
                         "(P, ps, Hkv, D)")
    rows = q.dim() == 3
    B, S = (q.shape[0], 1) if rows else q.shape[:2]
    H, D = q.shape[-2:]
    P, ps, Hkv, _ = k_pool.shape
    n = block_table.shape[1] if block_table.dim() == 2 else -1
    for x, name, dtype, shape in (
            (q, "q", q.dtype, tuple(q.shape)),
            (k_pool, "k_pool", q.dtype, (P, ps, Hkv, D)),
            (v_pool, "v_pool", q.dtype, (P, ps, Hkv, D)),
            (ids_pool, "ids_pool", torch.int32, (P, ps)),
            (block_table, "block_table", torch.int32, (B, n)),
            (pos, "pos", torch.int32, (B,) if rows else (B, S))):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {dtype} of shape {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned")
    if q.dtype not in _DTYPES:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"{H} query heads do not group over {Hkv} kv heads")
    G = H // Hkv
    if G > 32 or D not in HEAD_DIMS or ps < 1:
        raise ValueError(f"the kernel takes at most 32 query heads per kv "
                         f"head and head_dim in {HEAD_DIMS} (G={G}, D={D})")
    if smem_bytes(S, G, D, ps, q.element_size()) > SMEM_LIMIT:
        raise ValueError(f"page_size {ps} with head_dim {D} needs more "
                         f"than {SMEM_LIMIT} bytes of shared memory per "
                         f"block")
    if (max(P * ps * Hkv * D, q.numel(), B * n) >= 2 ** 31
            or B > 65535 or Hkv > 65535):
        raise ValueError("each tensor must hold fewer than 2^31 elements")
    return B, S, H, D, P, ps, Hkv, n


def paged_attention(q, k_pool, v_pool, ids_pool, block_table, pos, *,
                    window: int = 0) -> torch.Tensor:
    """q (R, H, D) with block_table (R, n_pages) and pos (R,), or
    q (B, S, H, D) with block_table (B, n_pages) and pos (B, S); k/v pools
    (P, ps, Hkv, D) float32 or bfloat16 (q's dtype), ids_pool (P, ps) and
    the tables int32 -> q's shape and dtype. Block-table entries name pages
    in [0, P)."""
    refuse_grad("paged_attention", q, k_pool, v_pool)
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, ids_pool, block_table,
                                   pos, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on CPU or CUDA tensors, "
                         f"not {q.device}")
    B, S, H, D, P, ps, Hkv, n = check_inputs(q, k_pool, v_pool, ids_pool,
                                             block_table, pos)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    ptrs = [x.data_ptr() for x in (q, k_pool, v_pool, ids_pool, block_table,
                                   pos, out)]
    route = _route(S, q.dtype)
    tr = tile_rows(S, H // Hkv, route)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "mma":
            err = _lib().paged_extend_launch(
                *ptrs, B, S, H, Hkv, D, P, ps, n, int(window), tr,
                FA.scale_log2(D), stream)
        else:  # split-K scratch: m and l (B, S, H, splits), acc (..., D)
            parts = B * S * H * -(-n // SPLIT) if route == "split" else 0
            base = (_scratch(q.device, stream, parts * (D + 2)).data_ptr()
                    if parts else 0)
            err = _lib().paged_rows_launch(
                *ptrs, base, base + 4 * parts, base + 8 * parts, B, S, H,
                Hkv, D, P, ps, n, int(window), tr, int(route == "split"),
                _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"paged_attention launch failed: CUDA error {err}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
