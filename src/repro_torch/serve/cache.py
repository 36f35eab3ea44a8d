"""KV-cache management for the continuous-batching engine (the counterpart
of the reference's ``serve/cache.py``).

``KVCacheManager`` owns the contiguous decode cache for a fixed set of slots
and all per-slot bookkeeping the scheduler needs: per-slot positions
(``pos[slot]`` is each slot's next decode position), slot recycling (a freed
slot's ``pos_ids`` are invalidated and the arrays reused), and page
accounting (``pages_in_use``/``peak_pages``, kept incrementally;
``recount_pages()`` recomputes from scratch).

``PagedKVCacheManager`` makes pages real: the device cache is a pool of
``total_pages`` physical pages plus one permanently invalid **null page**;
each slot owns a block table mapping logical page index -> physical page,
filled from a free-list :class:`PageAllocator`. The engine's paged step
hands the pool and the block tables to ``Model.decode``, which writes each
chunk's K/V into the pages in place and runs the paged-attention kernel on
the pool; ``gather_logical``/``scatter_logical`` (the reference's fused
step) serve only ``read_rows``/``write_rows``/``restore`` here. Freed and
trimmed pages get their ``pos_ids`` invalidated before they return to the
pool. A sliding-window model's slot spans its ring, ``seq_len =
min(max_len, window)`` entries, as the reference's probe finds it; where
the ring can wrap under a chunk, each slot also owns scratch pages for one
chunk (see :class:`PagedKVCacheManager`).

The cache's layout belongs to the model (``models/transformer.lm_cache``):
``KVCacheManager`` finds each leaf's slot axis as the reference does, by
building the cache at one and at two slots (on the ``meta`` device, so
nothing is allocated) and taking the axis where they differ
(:func:`slot_axes`): axis 1 of the ``(L, B, ...)`` stacks, axis 2 of the
hybrid's ``(n_groups, k, B, ...)`` group states. Only ``pos_ids`` leaves are
invalidated when a slot is freed; a recurrent state is overwritten whole
when its slot is next filled. The paged pool serves attention-only stacks
(pages on the slot axis and ``page_size`` entries on the sequence axis
after it: axis 1 and 2 of a stack's ``(L, pages, ps, ...)`` leaves, axis 0
and 1 of an MoE stack's ``dense{i}`` blocks); the engine refuses it for the
recurrent families, as the reference does.

``ExpandableKVCacheManager`` starts at ``initial_len`` entries per slot and
doubles up to ``max_len`` on demand (``ensure``): the leaves that carry a
sequence axis, found by building the cache at two lengths and taking the
axis where they differ (:func:`probe_axes`), grow, K/V padded with 0 and
``pos_ids`` with -1; the leaves that carry none (SSM and conv states, a
window-clamped ring) stay as they are. A growth replaces the grown
tensors, so the engine reads ``mgr.cache`` afresh on every step.
``ExpandablePagedKVCacheManager`` sizes its pool for ``max_len`` up front
and grows only the block tables, with null-page columns: a live page never
moves. ``restore`` pads rows captured before a growth out to the current
shapes (``pos_ids`` with -1), in both kinds.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.attention import cache_len


def tree_map(fn, *trees, _path=()):
    """``fn(path, *leaves)`` over nested dicts of tensors (``path`` is the
    tuple of keys down to the leaf, e.g. ``("stack", "pos_ids")``)."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees), _path=_path + (k,))
                for k in trees[0]}
    return fn(_path, *trees)


def probe_axes(a, b):
    """Per leaf, the first axis where two cache trees' shapes differ, or
    None where they agree (the reference's ``_probe_axes``, NO_AXIS)."""
    return tree_map(lambda path, x, y: next(
        (i for i, (m, n) in enumerate(zip(x.shape, y.shape)) if m != n),
        None), a, b)


def slot_axes(model, max_len: int):
    """The slot axis of every leaf of ``model.cache``: the one axis where
    the cache at two slots differs from the cache at one."""
    return probe_axes(*(model.cache(n, max_len, device="meta")
                        for n in (1, 2)))


def _pad_to(path, row, shape, skip=None):
    """``row`` grown at its ends to ``shape`` (axis ``skip`` left as it
    is), with -1 for ``pos_ids`` and 0 elsewhere."""
    for ax, want in enumerate(shape):
        pad = want - row.shape[ax]
        if ax == skip or pad <= 0:
            continue
        fill = list(row.shape)
        fill[ax] = pad
        row = torch.cat([row, torch.full(fill, _fill(path), dtype=row.dtype,
                                         device=row.device)], ax)
    return row


def _doubled(capacity: int, needed: int, limit: int) -> int:
    """``capacity`` doubled (at most to ``limit``) until it holds
    ``needed``; ``ValueError`` past ``limit``."""
    if needed > limit:
        raise ValueError(f"request needs {needed} tokens; max_len={limit}")
    while capacity < needed:
        capacity = min(capacity * 2, limit)
    return capacity


def _slots(axis: int, ids):
    """Index of the slots ``ids`` along a leaf's slot axis."""
    return (slice(None),) * axis + (ids,)


def _fill(path) -> int:
    return -1 if path[-1] == "pos_ids" else 0


class KVCacheManager:
    """Fixed-capacity cache over ``slots`` rows of length ``max_len``."""

    def __init__(self, model, slots: int, max_len: int,
                 page_size: int = 16, alloc: bool = True):
        self.model = model
        self.slots = slots
        self.max_len = max_len
        self.page_size = page_size
        if alloc:
            self.cache = model.cache(slots, max_len)
        self.axes = slot_axes(model, max_len)
        # host-side bookkeeping (no device sync needed to schedule)
        self.pos = np.zeros(slots, np.int32)        # next decode position
        self.lengths = np.zeros(slots, np.int32)    # prompt length
        self._free: List[int] = list(range(slots))
        self._pages_per_slot = math.ceil(max_len / page_size)
        self.peak_pages = 0
        self._slot_pages = np.zeros(slots, np.int32)
        self._pages_in_use = 0

    def _invalidate(self, cache, slot_ids):
        """Mark the slots' rows invalid (``pos_ids = -1``), in place; caches
        without a position table (recurrent states) are left as they are."""
        def inv(path, leaf, axis):
            if path[-1] == "pos_ids":
                leaf[_slots(axis, torch.as_tensor(
                    slot_ids, dtype=torch.long, device=leaf.device))] = -1
            return leaf

        return tree_map(inv, cache, self.axes)

    # -- slot lifecycle -------------------------------------------------------
    @property
    def free_slots(self) -> List[int]:
        return list(self._free)

    @property
    def active_slots(self) -> List[int]:
        return [s for s in range(self.slots) if s not in self._free]

    def _set_slot_pages(self, slot: int, n: int) -> None:
        self._pages_in_use += n - int(self._slot_pages[slot])
        self._slot_pages[slot] = n
        self.peak_pages = max(self.peak_pages, self._pages_in_use)

    def allocate(self, prompt_len: int) -> int:
        """Claim a free slot for a request; returns the slot id."""
        slot = self._free.pop(0)
        self.pos[slot] = 0
        self.lengths[slot] = prompt_len
        self._set_slot_pages(slot, 1)  # an allocated slot holds >= 1 page
        return slot

    def free(self, slot: int):
        """Recycle a slot: pages return to the pool, row marked invalid.
        Raises on double-free or free-of-unallocated."""
        if not 0 <= slot < self.slots:
            raise ValueError(
                f"free of invalid slot {slot} (valid: 0..{self.slots - 1})")
        if slot in self._free:
            raise ValueError(f"double free of slot {slot}")
        self.pos[slot] = 0
        self.lengths[slot] = 0
        self._set_slot_pages(slot, 0)
        self._free.append(slot)
        self._invalidate(self.cache, [slot])

    # -- page accounting ------------------------------------------------------
    @property
    def total_pages(self) -> int:
        return self.slots * self._pages_per_slot

    @property
    def pages_in_use(self) -> int:
        return self._pages_in_use

    @property
    def free_pages(self) -> int:
        return self.total_pages - self._pages_in_use

    def slot_pages(self, slot: int) -> int:
        return int(self._slot_pages[slot])

    def recount_pages(self) -> int:
        """Recompute page occupancy from scratch (O(slots))."""
        used = 0
        for s in range(self.slots):
            if s in self._free:
                continue
            used += max(1, math.ceil(int(self.pos[s]) / self.page_size))
        return used

    # -- cache writes ---------------------------------------------------------
    def write_rows(self, slot_ids, rows):
        """Scatter cache rows (batch == len(slot_ids)) into slots."""
        ids = list(slot_ids)

        def put(path, leaf, axis, row):
            leaf[_slots(axis, ids)] = torch.as_tensor(row).to(leaf.device,
                                                              leaf.dtype)
            return leaf

        tree_map(put, self.cache, self.axes, rows)

    def read_rows(self, slot_ids):
        """Gather cache rows (batch == len(slot_ids)) out of slots — the
        device->host read of preemption."""
        ids = list(slot_ids)
        return tree_map(
            lambda path, leaf, axis: leaf[_slots(axis, ids)].clone(),
            self.cache, self.axes)

    def restore(self, slot: int, rows, pos: int):
        """Scatter one preempted row set back into a (re)allocated slot and
        rewind its decode position — the resume half of preemption. Rows
        captured before an :class:`ExpandableKVCacheManager` growth are
        padded out to the current leaf shapes (-1 for ``pos_ids``)."""
        rows = tree_map(lambda path, row, axis, cur: _pad_to(
            path, torch.as_tensor(row), cur.shape, skip=axis),
            rows, self.axes, self.cache)
        self.write_rows([slot], rows)
        self.pos[slot] = int(pos)
        self._set_slot_pages(
            slot, max(1, math.ceil(int(pos) / self.page_size)))

    def advance(self, slot_ids, counts):
        for s, n in zip(slot_ids, counts):
            self.pos[s] += int(n)
            self._set_slot_pages(
                s, max(1, math.ceil(int(self.pos[s]) / self.page_size)))


class ExpandableKVCacheManager(KVCacheManager):
    """Starts at ``initial_len`` entries per slot and doubles up to
    ``max_len``. A growth re-allocates only the leaves that carry a
    sequence axis (probed: SSM and conv states and a window-clamped ring
    are left alone), K/V padded with 0 and ``pos_ids`` with -1."""

    def __init__(self, model, slots: int, max_len: int,
                 initial_len: int = 64, page_size: int = 16):
        initial_len = min(initial_len, max_len)
        super().__init__(model, slots, max_len, page_size, alloc=False)
        self.capacity = initial_len
        self.cache = model.cache(slots, initial_len)
        self.grows = 0

    def ensure(self, needed: int):
        """Grow the capacity (doubling) until it holds ``needed`` tokens
        per slot; more than ``max_len`` raises ``ValueError`` (the
        reference's raises where the capacity is ``max_len`` already and
        loops forever where it is not)."""
        if needed <= self.capacity:
            return
        new_cap = _doubled(self.capacity, needed, self.max_len)
        old, new = (self.model.cache(self.slots, n, device="meta")
                    for n in (self.capacity, new_cap))
        # a leaf grows to its shape at the new length (a ring longer than
        # the old capacity stops at its window)
        self.cache = tree_map(
            lambda path, leaf, ax, want: leaf if ax is None else _pad_to(
                path, leaf, want.shape),
            self.cache, probe_axes(old, new), new)
        self.capacity = new_cap
        self.grows += 1


class HostPagePool:
    """Host-side page pool for preempted requests: evicted KV rows live in
    host memory keyed by request id until resumption. The device slot is
    freed meanwhile — preemption returns pages to the admission pool.

    Accounting is page-exact: ``put`` records how many device pages the
    eviction released, so ``pages_held``/``peak_pages`` match the allocator
    ledger. Each entry carries a provenance ledger (origin allocator, device
    page ids, whether the origin freed them): ``take(owner=...)`` refuses a
    cross-allocator resume whose origin still owns the pages, and a resume
    whose position does not fit the target's ``max_len``."""

    def __init__(self):
        self._rows: Dict[Any, Any] = {}
        self._ledger: Dict[Any, Dict[str, Any]] = {}
        self.puts = 0
        self.peak = 0
        self.pages_held = 0   # device pages currently parked host-side
        self.pages_evicted = 0  # cumulative pages moved to host
        self.peak_pages = 0
        self.migrations = 0   # cross-allocator resumes (pod -> pod)

    def put(self, rid, rows, pos: int, pages: int = 1, *,
            owner=None, page_ids=None, freed: bool = True) -> None:
        host = tree_map(lambda path, t: t.detach().cpu(), rows)
        self._rows[rid] = (host, int(pos), int(pages))
        self._ledger[rid] = {
            "owner": owner,
            "page_ids": (None if page_ids is None
                         else [int(p) for p in np.asarray(page_ids).ravel()]),
            "freed": bool(freed),
        }
        self.puts += 1
        self.peak = max(self.peak, len(self._rows))
        self.pages_held += int(pages)
        self.pages_evicted += int(pages)
        self.peak_pages = max(self.peak_pages, self.pages_held)

    def put_pages(self, rid) -> int:
        """Pages a parked request holds (0 if not parked)."""
        entry = self._rows.get(rid)
        return 0 if entry is None else entry[2]

    def ledger(self, rid) -> Optional[Dict[str, Any]]:
        return self._ledger.get(rid)

    def take(self, rid, *, owner=None):
        """Pop (rows, pos) for a request being resumed; ``owner`` is the
        allocator about to receive the rows."""
        led = self._ledger.get(rid, {})
        rows, pos, pages = self._rows[rid]
        if owner is not None:
            origin = led.get("owner")
            foreign = origin is not None and origin is not owner
            if foreign and not led.get("freed", True):
                raise RuntimeError(
                    f"HostPagePool: refusing to resume request {rid!r} into "
                    f"a foreign allocator while its origin still owns the "
                    f"evicted pages; ledger={led}")
            cap = getattr(owner, "max_len", None)
            if cap is not None and int(pos) > int(cap):
                raise RuntimeError(
                    f"HostPagePool: request {rid!r} parked at pos={pos} "
                    f"exceeds the target allocator's max_len {cap}; "
                    f"ledger={led}")
            if foreign:
                self.migrations += 1
        del self._rows[rid]
        self._ledger.pop(rid, None)
        self.pages_held -= pages
        return rows, pos

    def __contains__(self, rid) -> bool:
        return rid in self._rows

    def __len__(self) -> int:
        return len(self._rows)


# =============================================================================
# paged attention: free-list allocator + block-table manager
# =============================================================================


class PageAllocator:
    """Free-list allocator over ``total_pages`` physical pages, with an
    ownership bitmap guarding double-frees."""

    def __init__(self, total_pages: int):
        self.total = int(total_pages)
        self._free: List[int] = list(range(self.total))
        self._owned = np.zeros(self.total, bool)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.total - len(self._free)

    def alloc(self, n: int) -> List[int]:
        """Claim ``n`` pages; raises when the pool cannot cover them."""
        if n > len(self._free):
            raise RuntimeError(
                f"page pool exhausted: want {n}, have {len(self._free)}")
        take, self._free = self._free[:n], self._free[n:]
        for p in take:
            self._owned[p] = True
        return take

    def free(self, pages) -> None:
        for p in pages:
            p = int(p)
            if not 0 <= p < self.total:
                raise ValueError(
                    f"free of invalid page {p} (valid: 0..{self.total - 1})")
            if not self._owned[p]:
                raise ValueError(f"double free of page {p}")
            self._owned[p] = False
            self._free.append(p)


class PagedKVCacheManager:
    """Block-table KV cache: non-contiguous pages behind the same slot API.

    The device pool is ``model.cache(total_pages + 1 + scratch, page_size)``:
    pages on the slot axis, ``page_size`` tokens on the sequence axis, and
    index ``total_pages`` is the **null page**, permanently invalid
    (``pos_ids = -1``), the target of every unallocated block-table entry.

    A slot's logical extent is ``seq_len``: ``max_len``, or a
    sliding-window model's ring ``min(max_len, window)``. Where the ring
    is as long as the window, a chunk of the step evicts entries that its
    earlier tokens still see, so each slot also owns ``ceil(chunk /
    page_size)`` scratch pages (``scratch_table``, after the null page),
    reserved here and outside the allocator's count, so that
    ``pages_in_use`` stays the reference's: the model's step passes each
    chunk through them (``attention.gqa_decode``). ``chunk`` is the widest
    step the engine makes (its ``prefill_chunk``)."""

    def __init__(self, model, slots: int, max_len: int,
                 page_size: int = 16, total_pages: Optional[int] = None,
                 chunk: int = 1):
        cfg = model.cfg
        window = cfg.sliding_window
        if window and window <= page_size:
            raise ValueError(
                f"page_size {page_size} must be < sliding_window {window}")
        self.model = model
        self.slots = slots
        self.max_len = max_len
        self.page_size = page_size
        self.seq_len = cache_len(cfg, max_len)  # the logical per-slot extent
        if self.seq_len % page_size:
            raise ValueError(
                f"sequence extent {self.seq_len} not divisible by "
                f"page_size {page_size}")
        self.pages_per_slot = self.seq_len // page_size
        self.total_pages = (slots * self.pages_per_slot
                            if total_pages is None else int(total_pages))
        self.null_page = self.total_pages
        n_scratch = (math.ceil(chunk / page_size)
                     if window and self.seq_len >= window else 0)
        self.scratch_table = (self.null_page + 1 + np.arange(
            slots * n_scratch, dtype=np.int32).reshape(slots, n_scratch)
            if n_scratch else None)
        self.axes = slot_axes(model, page_size)
        self.pool = model.cache(self.total_pages + 1 + slots * n_scratch,
                                page_size)
        self.allocator = PageAllocator(self.total_pages)
        self.block_table = np.full((slots, self.pages_per_slot),
                                   self.null_page, np.int32)
        # host-side bookkeeping, mirroring KVCacheManager
        self.pos = np.zeros(slots, np.int32)
        self.lengths = np.zeros(slots, np.int32)
        self._free: List[int] = list(range(slots))
        self._slot_pages = np.zeros(slots, np.int32)
        self._pages_in_use = 0
        self.peak_pages = 0

    def _invalidate_pages(self, pool, page_ids):
        """Mark pages invalid (``pos_ids = -1``), in place."""
        def inv(path, leaf, axis):
            if path[-1] == "pos_ids":
                leaf[_slots(axis, torch.as_tensor(
                    page_ids, dtype=torch.long, device=leaf.device))] = -1
            return leaf

        return tree_map(inv, pool, self.axes)

    # -- pool <-> logical layout (preemption and restore) ----------------------
    def gather_logical(self, pool, bt):
        """Gather block tables ``bt`` (n, pages) into a slot-contiguous
        logical cache (n, pages * page_size)."""
        def take(path, leaf, axis):
            b = torch.as_tensor(bt, dtype=torch.long, device=leaf.device)
            g = leaf[_slots(axis, b)]  # (..., n, pages, ps, ...)
            return g.reshape(*leaf.shape[:axis], b.shape[0],
                             b.shape[1] * self.page_size,
                             *leaf.shape[axis + 2:])

        return tree_map(take, pool, self.axes)

    def inverse_map(self) -> np.ndarray:
        """Host-side inverse of the block tables: physical page -> flat
        logical page index (``slot * width + j``), or ``slots * width`` for
        unallocated pages and the null page."""
        B, W = self.block_table.shape
        inv = np.full(self.total_pages + 1, B * W, np.int32)
        flat = self.block_table.reshape(-1)
        idx = np.arange(B * W, dtype=np.int32)
        alloc = flat != self.null_page
        inv[flat[alloc]] = idx[alloc]
        return inv

    def scatter_logical(self, pool, logical, bt):
        """Scatter a logical cache back into the pool through ``bt``, in
        place; the null page is re-filled (``pos_ids = -1``, zeros)
        afterwards, since every unallocated entry aliases it."""
        ps, null = self.page_size, self.null_page

        def put(path, leaf, axis, lg):
            b = torch.as_tensor(bt, dtype=torch.long, device=leaf.device)
            v = torch.as_tensor(lg).to(leaf.device, leaf.dtype)
            leaf[_slots(axis, b)] = v.reshape(
                *leaf.shape[:axis], *b.shape, ps, *leaf.shape[axis + 2:])
            leaf[_slots(axis, null)] = _fill(path)
            return leaf

        return tree_map(put, pool, self.axes, logical)

    # -- slot lifecycle -------------------------------------------------------
    @property
    def cache(self):
        return self.pool

    @property
    def free_slots(self) -> List[int]:
        return list(self._free)

    @property
    def active_slots(self) -> List[int]:
        return [s for s in range(self.slots) if s not in self._free]

    @property
    def pages_in_use(self) -> int:
        return self._pages_in_use

    @property
    def free_pages(self) -> int:
        return self.allocator.free_pages

    def recount_pages(self) -> int:
        """Count allocated block-table entries from scratch."""
        return int(np.sum(self.block_table != self.null_page))

    def slot_pages(self, slot: int) -> int:
        return int(self._slot_pages[slot])

    def pages_needed(self, slot: int, upto: int) -> int:
        """New pages ``extend(slot, upto)`` would have to claim."""
        upto = min(int(upto), self.block_table.shape[1] * self.page_size)
        need = max(1, math.ceil(upto / self.page_size))
        return max(0, min(need, self.block_table.shape[1])
                   - int(self._slot_pages[slot]))

    def allocate(self, prompt_len: int) -> int:
        """Claim a free slot and its first page; returns the slot id."""
        slot = self._free.pop(0)
        self.pos[slot] = 0
        self.lengths[slot] = prompt_len
        (page,) = self.allocator.alloc(1)
        self.block_table[slot, 0] = page
        self._slot_pages[slot] = 1
        self._pages_in_use += 1
        self.peak_pages = max(self.peak_pages, self._pages_in_use)
        return slot

    def extend(self, slot: int, upto: int) -> int:
        """Grow a slot's block table to cover positions ``[0, upto)``;
        returns the number of pages claimed."""
        width = self.block_table.shape[1]
        upto = min(int(upto), width * self.page_size)
        need = min(max(1, math.ceil(upto / self.page_size)), width)
        have = int(self._slot_pages[slot])
        if need <= have:
            return 0
        new = self.allocator.alloc(need - have)
        self.block_table[slot, have:need] = new
        self._slot_pages[slot] = need
        self._pages_in_use += need - have
        self.peak_pages = max(self.peak_pages, self._pages_in_use)
        return need - have

    def trim(self, slot: int, upto: int) -> int:
        """Return pages past ``ceil(upto / page_size)`` to the pool (the
        speculative-decode rollback); freed pages are invalidated. Returns
        the number of pages freed."""
        keep = max(1, math.ceil(int(upto) / self.page_size))
        have = int(self._slot_pages[slot])
        if keep >= have:
            return 0
        pages = self.block_table[slot, keep:have].copy()
        self.block_table[slot, keep:have] = self.null_page
        self._slot_pages[slot] = keep
        self._pages_in_use -= have - keep
        self.allocator.free(pages)
        self._invalidate_pages(self.pool, pages)
        return have - keep

    def free(self, slot: int):
        """Recycle a slot: all its pages are invalidated and returned."""
        if not 0 <= slot < self.slots:
            raise ValueError(
                f"free of invalid slot {slot} (valid: 0..{self.slots - 1})")
        if slot in self._free:
            raise ValueError(f"double free of slot {slot}")
        have = int(self._slot_pages[slot])
        pages = self.block_table[slot, :have].copy()
        self.block_table[slot, :have] = self.null_page
        self._slot_pages[slot] = 0
        self._pages_in_use -= have
        self.allocator.free(pages)
        self._invalidate_pages(self.pool, pages)
        self.pos[slot] = 0
        self.lengths[slot] = 0
        self._free.append(slot)

    # -- cache reads/writes (logical rows, for preemption) ---------------------
    def write_rows(self, slot_ids, rows):
        """Scatter logical rows (batch == len(slot_ids)) into the slots'
        pages (the rows must already be covered by ``extend``)."""
        bt = self.block_table[np.asarray(slot_ids)]
        self.scatter_logical(self.pool, self._fit_rows(rows), bt)

    def read_rows(self, slot_ids):
        """Gather logical rows trimmed to the slots' allocated pages — the
        page-exact device->host payload of preemption."""
        ids = np.asarray(slot_ids)
        width = int(max(1, self._slot_pages[ids].max()))
        return self.gather_logical(self.pool, self.block_table[ids, :width])

    def _fit_rows(self, rows):
        """Pad logical rows out to the block-table width (fill -1 for
        ``pos_ids``)."""
        width = self.block_table.shape[1] * self.page_size

        def fit(path, row, axis):
            row = torch.as_tensor(row)
            seq = axis + 1
            pad = width - row.shape[seq]
            if pad <= 0:
                return row
            shape = list(row.shape)
            shape[seq] = pad
            return torch.cat([row, torch.full(shape, _fill(path),
                                              dtype=row.dtype,
                                              device=row.device)], seq)

        return tree_map(fit, rows, self.axes)

    def restore(self, slot: int, rows, pos: int):
        """Scatter a preempted row set back into a (re)allocated slot —
        possibly onto other physical pages than it left."""
        self.extend(slot, int(pos))
        self.write_rows([slot], rows)
        self.pos[slot] = int(pos)

    def advance(self, slot_ids, counts):
        for s, n in zip(slot_ids, counts):
            self.pos[s] += int(n)
            self.extend(s, int(self.pos[s]))


class ExpandablePagedKVCacheManager(PagedKVCacheManager):
    """A paged manager whose per-slot capacity starts at ``initial_len`` and
    doubles up to ``max_len``. A growth only widens the block tables with
    null-page columns: live pages never move and the pool, sized for
    ``max_len`` up front, is untouched, so it costs O(slots) on the host.
    The model's step reads the table's width as the slot's extent, so a
    grown table serves at once."""

    def __init__(self, model, slots: int, max_len: int,
                 initial_len: int = 64, page_size: int = 16,
                 total_pages: Optional[int] = None, chunk: int = 1):
        window = model.cfg.sliding_window
        if window and window < max_len:
            raise ValueError(
                "expandable paged cache requires sliding_window >= max_len")
        super().__init__(model, slots, max_len, page_size=page_size,
                         total_pages=total_pages, chunk=chunk)
        initial_len = min(max(initial_len, page_size), max_len)
        init_pages = max(1, math.ceil(initial_len / page_size))
        self.block_table = self.block_table[:, :init_pages].copy()
        self.capacity = init_pages * page_size
        self.grows = 0

    def ensure(self, needed: int):
        """Grow the capacity (doubling) until it holds ``needed`` tokens
        per slot; the new columns name the null page until ``extend``
        claims pages for them."""
        if needed <= self.capacity:
            return
        new_cap = _doubled(self.capacity, needed, self.seq_len)
        grown = np.full((self.slots, new_cap // self.page_size),
                        self.null_page, np.int32)
        grown[:, :self.block_table.shape[1]] = self.block_table
        self.block_table = grown
        self.capacity = new_cap
        self.grows += 1
