"""Serving engine: continuous batching with per-slot positions (the
counterpart of the reference's ``serve/engine.py``).

Requests enter a queue; every ``step()`` the engine (1) admits queued
requests into free cache slots (honouring ``admit_cap``), and (2) advances
all active slots with ONE model step, sampling on the device and one host
sync per tick. Two scheduling paths, picked by model family as in the
reference:

- **ragged** (attention-only stacks, dense and moe; a sliding-window ring
  as long as one chunk fits it): the step carries chunked-prefill
  extends for slots still consuming their prompt and single-token decode
  for slots mid-generation, each slot at its own ``pos`` (the ragged
  ``pos``/``n_valid`` contract of ``Model.decode``), so a request admitted
  while others are mid-decode produces what it would alone. Every slot's
  row, an idle one included, goes through the model step, so an MoE
  layer's dispatch group holds every row, as the reference's does;
- **stateful** (the ssm and hybrid families, and a sliding-window model
  whose chunk would lap its ring): a recurrent state would absorb padded
  prompt tokens, so admission runs an exact-length prefill of
  the prompt at batch 1 (the SSD-scan kernel in every mamba layer), writes
  the slot's rows and samples the first token from the last logit; the
  step is then an S = 1 decode over all slots. The chunked scan takes a
  prompt of at most ``ssm_chunk`` tokens or a multiple of it, as the
  reference's does; any other length raises ``ValueError``.

With ``paged=True`` the cache is :class:`~repro_torch.serve.cache.
PagedKVCacheManager`'s page pool behind per-slot block tables, and the step
hands the pool and the tables to ``Model.decode``: each layer writes the
chunk's K/V into its pages in place and runs the paged-attention kernel on
the pool. The reference instead gathers a logical cache, runs the unchanged
decode and scatters the pool back, donating the pool buffer so the scatter
is in place; here the in-place page write takes the place of both. A
sliding-window model's slot spans its ring of ``min(max_len, window)``
entries; where the ring can wrap under a chunk, the step also hands each
slot's scratch pages to the model, which passes the chunk through them so
that the kernel sees the pre-update ring plus the chunk, as the
reference's decode does. Admission and extension run at page granularity
off the actual free list.

``speculate=k`` adds draft-k self-speculative decode (greedy only):
n-gram prompt-lookup drafts ride the ragged contract as an ``S = k+1``
extend, one step scores every draft row, and the accepted prefix (plus the
bonus token) is what sequential greedy would have produced; the rejected
tail's pages roll back through the allocator (``trim``). A verify chunk of
up to 16 rows (k <= 15; ``paged_attention.CHUNK_ROWS``) gives every row its
decode row's arithmetic, in float32 and bf16 alike: the paged kernel scores
it so, and the model runs the ops whose rounding depends on the row count a
column at a time (``models.layers.by_column``), so the accepted prefix is
bit for bit what greedy decoding of the same traffic produces. With k > 15
that guarantee lapses: the chunk takes every op whole. A bf16 stream can
also depend on what else shares its tick: a decode row that rides a
prefill chunk wider than 16 goes through that chunk's products. In an MoE
layer the verify chunk's routes share one dispatch group's capacity, as in
the reference, so where the capacity drops a route otherwise than a
decode tick would, the streams part (ROADMAP queue 3).

The vlm and audio families are refused (``ValueError``): the engine feeds
its model tokens only, as the reference's does, and they are served through
``serve/step``'s prefill and decode steps over a batch dict.

Paged mode and speculation take the ragged path only, as in the reference,
and speculation refuses a window shorter than ``max_len`` (a wrapped ring
cannot roll a rejected draft back).

``expandable=True`` starts each slot's cache at the managers' default 64
entries and doubles it up to ``max_len`` where a tick, a resume or a
stateful prefill needs more (:class:`~repro_torch.serve.cache.ExpandableKVCacheManager`, or
with ``paged=True`` :class:`~repro_torch.serve.cache.
ExpandablePagedKVCacheManager`, which widens the block tables only), at
the four places the reference's engine calls ``ensure``. A growth replaces
the contiguous cache's tensors, so the step reads ``mgr.cache`` afresh each
tick; the paged step sizes its extent by the table's width, which a growth
changes between ticks.
Every ``step()`` emits a ``TickSample`` to the ``on_tick`` subscribers.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.control.telemetry import TickSample
from repro_torch.models.model import Model
from repro_torch.serve import scheduler as sched
from repro_torch.serve.cache import (ExpandableKVCacheManager,
                                     ExpandablePagedKVCacheManager,
                                     HostPagePool, KVCacheManager,
                                     PagedKVCacheManager)
from repro_torch.serve.step import sample


@dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (P,) int32
    max_new: int = 16
    priority: int = 0     # lower preempts first under thermal emergency
    out: List[int] = field(default_factory=list)
    done: bool = False
    error: Optional[str] = None
    fed: int = 0          # prompt tokens already written to the cache
    submit_tick: int = 0  # engine tick at submission (queue-age / SLO)
    finish_tick: int = 0
    preempts: int = 0     # times evicted to the host page pool


class Engine:
    def __init__(self, model: Model, batch_slots: int = 4,
                 max_len: int = 256, eos_id: int = 1,
                 temperature: float = 0.0,
                 admit_cap: Optional[int] = None,
                 top_k: int = 0, prefill_chunk: int = 16,
                 page_size: int = 16, expandable: bool = False,
                 paged: bool = False, total_pages: Optional[int] = None,
                 speculate: int = 0,
                 seed: int = 0, warmup: bool = True,
                 pool: Optional[HostPagePool] = None):
        if model.cfg.family in ("vlm", "audio"):
            raise ValueError(
                f"the engine feeds its model tokens only, so it cannot serve "
                f"the {model.cfg.family} family (its model also takes the "
                f"frontend's embeddings); serve it with serve/step's "
                f"make_prefill_step and make_decode_step over a batch dict, "
                f"as the reference does")
        self.model = model
        self.B = batch_slots
        self.max_len = max_len
        self.eos = eos_id
        self.temperature = temperature
        self.top_k = top_k
        self.prefill_chunk = max(1, min(prefill_chunk, max_len))
        cfg = model.cfg
        self._ragged = (cfg.family in ("dense", "moe")
                        and (not cfg.sliding_window
                             or self.prefill_chunk <= cfg.sliding_window))
        self._paged = bool(paged)
        if self._paged and not self._ragged:
            raise ValueError(
                "paged=True requires the ragged path (dense/moe attention); "
                "recurrent state cannot be gathered through block tables")
        self._spec_k = max(int(speculate), 0)
        if self._spec_k:
            if temperature != 0.0:
                raise ValueError("speculate requires greedy decoding "
                                 "(temperature=0): verification compares "
                                 "drafts against the argmax rows")
            if not self._ragged:
                raise ValueError("speculate requires the ragged path")
            if cfg.sliding_window and cfg.sliding_window < max_len:
                raise ValueError(
                    "speculate requires sliding_window >= max_len")
        self._scratch_dev: Optional[torch.Tensor] = None
        self._expandable = bool(expandable)
        if self._paged:
            mgr_cls = (ExpandablePagedKVCacheManager if expandable
                       else PagedKVCacheManager)
            self.mgr = mgr_cls(model, batch_slots, max_len,
                               page_size=page_size, total_pages=total_pages,
                               chunk=self.prefill_chunk)
            if self.mgr.scratch_table is not None:
                self._scratch_dev = torch.as_tensor(
                    self.mgr.scratch_table, dtype=torch.int32,
                    device=model.device)
        else:
            mgr_cls = (ExpandableKVCacheManager if expandable
                       else KVCacheManager)
            self.mgr = mgr_cls(model, batch_slots, max_len,
                               page_size=page_size)
        self.slot_req: List[Optional[Request]] = [None] * self.B
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        # preempted KV rows, host side; pass a shared pool to let several
        # engines exchange requests
        self.pool = pool if pool is not None else HostPagePool()
        self.preempts = 0
        self.spec_proposed = 0  # draft tokens offered to verification
        self.spec_accepted = 0  # draft tokens accepted (== greedy)
        self._bt_host: Optional[np.ndarray] = None  # device bt cache key
        self._bt_dev: Optional[torch.Tensor] = None
        self.gen = torch.Generator(device=model.device)
        self.gen.manual_seed(int(seed))
        # control plane: admission throttle + tick telemetry subscribers
        self.admit_cap = admit_cap
        self.on_tick: List[Callable[[TickSample], None]] = []
        self.ticks = 0
        # new-token width of the last tick's step (0: no step ran)
        self.tick_width = 0
        if warmup:
            self._warmup()

    # -- the model step -------------------------------------------------------
    def step_logits(self, tokens, pos, n_valid) -> torch.Tensor:
        """One model step over all slots: tokens (B, S), pos (B,), n_valid
        (B,) host arrays -> logits (B, S, V); writes the cache (or the
        pages) in place."""
        dev = self.model.device
        toks = torch.as_tensor(tokens, device=dev)
        pos = torch.as_tensor(pos, dtype=torch.int32, device=dev)
        nv = torch.as_tensor(n_valid, dtype=torch.int32, device=dev)
        if self._paged:
            idle = np.flatnonzero(np.asarray(n_valid) == 0).tolist()
            logits, _ = self.model.decode(toks, self.mgr.pool, pos,
                                          n_valid=nv,
                                          block_table=self._bt_device(),
                                          scratch_table=self._scratch_dev,
                                          null_page=self.mgr.null_page,
                                          idle_slots=idle)
        else:
            logits, _ = self.model.decode(toks, self.mgr.cache, pos,
                                          n_valid=nv)
        return logits

    def _run_fused(self, plan: sched.TickPlan, spec: bool) -> np.ndarray:
        """One step over the plan; returns the host copy of the sampled
        tokens (B,), or of every row's greedy continuation (B, S) on a
        speculative verify tick — the tick's single host sync."""
        logits = self.step_logits(plan.tokens, plan.pos, plan.n_valid)
        if spec:
            out = torch.argmax(logits, dim=-1)
        else:
            S = logits.shape[1]
            idx = torch.as_tensor(np.clip(plan.n_valid - 1, 0, S - 1),
                                  device=logits.device).long()
            last = logits[torch.arange(self.B, device=logits.device), idx]
            out = sample(last, self.gen, self.temperature, self.top_k)
        return out.to(torch.int32).cpu().numpy()

    def _bt_device(self) -> torch.Tensor:
        """Device copy of the block table, re-uploaded only when the host
        table changed (steady decode reuses pages for page_size ticks)."""
        if self._bt_host is None or not np.array_equal(
                self._bt_host, self.mgr.block_table):
            self._bt_host = self.mgr.block_table.copy()
            self._bt_dev = torch.as_tensor(self._bt_host, dtype=torch.int32,
                                           device=self.model.device)
        return self._bt_dev

    def _warmup(self):
        """Run the step's width buckets once (on the card: the kernels'
        build and the libraries' set-up) with n_valid = 0 rows, which leave
        nothing visible in the cache."""
        widths = {1, self.prefill_chunk} if self._ragged else {1}
        if self._spec_k:
            widths.add(self._spec_k + 1)
        if self._expandable:
            # a width past the initial capacity first runs on the tick
            # that grows the cache to hold it
            widths = {S for S in widths if S <= self.mgr.capacity}
        zero = np.zeros(self.B, np.int32)
        for S in sorted(widths):
            self.step_logits(np.zeros((self.B, S), np.int32), zero, zero)
        if self._paged:
            self.mgr._invalidate_pages(self.mgr.pool, [self.mgr.null_page])
        else:
            self.mgr._invalidate(self.mgr.cache, [0])

    # -- public API -----------------------------------------------------------
    @property
    def cache(self):
        return self.mgr.cache

    def submit(self, req: Request):
        req.submit_tick = self.ticks
        self.queue.append(req)

    # -- admission ------------------------------------------------------------
    def _admit(self) -> int:
        """Admit queued requests into free slots (<= admit_cap per step).
        On the paged path admission is priced off the actual free page
        list: a fresh request needs one page now, a resume exactly the pages
        it parked."""
        cap = self.B if self.admit_cap is None else max(self.admit_cap, 0)
        admitted = 0
        while self.queue and self.mgr.free_slots and admitted < cap:
            if self._paged:
                head = self.queue[0]
                need = (self.pool.put_pages(head.rid)
                        if head.rid in self.pool else 1)
                if self.mgr.free_pages < max(need, 1):
                    break  # no pages — keep FIFO order, retry next tick
            req = self.queue.pop(0)
            if req.rid in self.pool:
                # resume a preempted request: its KV rows come back from
                # the host page pool bit for bit — no recompute
                slot = self.mgr.allocate(len(req.prompt))
                rows, pos = self.pool.take(req.rid, owner=self.mgr)
                if self._expandable:
                    self.mgr.ensure(pos + 1)
                self.mgr.restore(slot, rows, pos)
                self.slot_req[slot] = req
                admitted += 1
                continue
            if len(req.prompt) >= self.max_len:
                req.done = True
                req.error = "prompt_too_long"
                req.finish_tick = self.ticks
                self.finished.append(req)
                continue  # a reject is not an admission
            slot = self.mgr.allocate(len(req.prompt))
            self.slot_req[slot] = req
            req.fed = 0
            if not self._ragged:
                self._prefill_into(slot, req)
            admitted += 1
        return admitted

    # -- thermal-emergency preemption -----------------------------------------
    def preempt_to(self, keep_active: int) -> int:
        """Evict active slots until at most ``keep_active`` stay busy.
        Victims are the lowest-priority, newest requests; each one's KV rows
        move to the host page pool, its device slot is freed, and the
        request re-queues at the head for identical resumption. Returns the
        eviction count."""
        active = [(s, r) for s, r in enumerate(self.slot_req)
                  if r is not None]
        n_evict = len(active) - max(int(keep_active), 0)
        if n_evict <= 0:
            return 0
        victims = sorted(active, key=lambda sr: (sr[1].priority,
                                                 -sr[1].submit_tick,
                                                 -sr[0]))[:n_evict]
        requeue = []
        for slot, req in sorted(victims, key=lambda sr: sr[1].submit_tick):
            pages = self.mgr.slot_pages(slot)
            rows = self.mgr.read_rows([slot])
            page_ids = (self.mgr.block_table[slot, :pages].copy()
                        if self._paged else None)
            self.pool.put(req.rid, rows, int(self.mgr.pos[slot]),
                          pages=pages, owner=self.mgr, page_ids=page_ids,
                          freed=True)
            self.slot_req[slot] = None
            self.mgr.free(slot)
            req.preempts += 1
            self.preempts += 1
            requeue.append(req)
        self.queue[:0] = requeue  # resume first, oldest first
        return n_evict

    def drain(self) -> List[Request]:
        """Evict every active slot to the host page pool and hand back the
        whole pending queue (resumable requests first, oldest first); the
        engine is left empty with all device pages free."""
        self.preempt_to(0)
        out, self.queue = self.queue, []
        return out

    def _prefill_into(self, slot: int, req: Request):
        """Stateful path: exact-length prefill at batch 1, the slot's rows
        written, the first token sampled from the last logit."""
        toks = torch.as_tensor(np.asarray(req.prompt, np.int32)[None],
                               device=self.model.device)
        if self._expandable:
            self.mgr.ensure(len(req.prompt) + 1)
            cap = self.mgr.capacity
        else:
            cap = self.max_len
        logits, rows = self.model.prefill({"tokens": toks}, max_len=cap)
        self.mgr.write_rows([slot], rows)
        self.mgr.advance([slot], [len(req.prompt)])
        req.fed = len(req.prompt)
        tok = sample(logits[:, -1], self.gen, self.temperature, self.top_k)
        self._append(req, slot, int(tok[0]))

    # -- speculative drafting -------------------------------------------------
    def _draft(self, req: Request, k: int) -> np.ndarray:
        """n-gram prompt-lookup self-speculation (model-free, greedy): the
        tokens that followed the most recent earlier occurrence of the last
        token in the request's own context; up to ``k`` of them."""
        ctx = np.concatenate([np.asarray(req.prompt, np.int32),
                              np.asarray(req.out, np.int32)])
        hits = np.nonzero(ctx[:-1] == ctx[-1])[0]
        if hits.size == 0:
            return np.zeros(0, np.int32)
        j = int(hits[-1])
        return ctx[j + 1:j + 1 + k].astype(np.int32)

    # -- the fused tick -------------------------------------------------------
    def _compose(self) -> Tuple[Optional[sched.TickPlan], bool]:
        """Compose the tick's work; the second value marks a speculative
        (all-decode, width ``k+1``) verify tick. Speculation stands down
        whenever any slot prefills or sits too close to ``max_len`` for the
        fixed verify width (the write would clamp)."""
        k = self._spec_k
        active = [(s, r) for s, r in enumerate(self.slot_req)
                  if r is not None]
        spec = bool(k) and bool(active) and all(
            r.fed >= len(r.prompt)
            and int(self.mgr.pos[s]) + k + 1 <= self.max_len
            for s, r in active)
        work: List[sched.SlotWork] = []
        for s, req in active:
            P = len(req.prompt)
            if req.fed < P:  # stream the prompt
                n = min(self.prefill_chunk, P - req.fed)
                work.append(sched.SlotWork(
                    s, "prefill",
                    np.asarray(req.prompt[req.fed:req.fed + n], np.int32),
                    completes=(req.fed + n == P)))
            elif spec:
                drafts = self._draft(req, k)
                toks = np.zeros(k + 1, np.int32)  # fixed width
                toks[0] = req.out[-1]
                toks[1:1 + len(drafts)] = drafts
                work.append(sched.SlotWork(
                    s, "decode", toks, n_valid=1 + len(drafts)))
            else:
                work.append(sched.SlotWork(
                    s, "decode", np.asarray([req.out[-1]], np.int32)))
        plan = sched.compose(work, self.mgr.pos, self.B, self.prefill_chunk)
        return plan, spec

    def _reserve_pages(self, plan: sched.TickPlan) -> bool:
        """Claim the pages this tick's real tokens will write (padded tails
        land on the inert null page). All-or-nothing: False when the free
        list cannot cover the whole plan."""
        need = sum(
            self.mgr.pages_needed(
                w.slot, int(self.mgr.pos[w.slot]) + int(plan.n_valid[w.slot]))
            for w in plan.work)
        if need > self.mgr.free_pages:
            return False
        for w in plan.work:
            self.mgr.extend(
                w.slot, int(self.mgr.pos[w.slot]) + int(plan.n_valid[w.slot]))
        return True

    def _tick(self) -> int:
        self.tick_width = 0
        plan, spec = self._compose()
        if plan is None:
            return 0
        if self._expandable:
            self.mgr.ensure(int(plan.pos.max() + plan.width))
        if self._paged:
            while not self._reserve_pages(plan):
                # out of pages mid-decode: preempt the newest low-priority
                # request (pages return to the free list) and recompose
                n_active = sum(r is not None for r in self.slot_req)
                if n_active <= 1:
                    raise RuntimeError(
                        "page pool exhausted: one request needs more pages "
                        f"than total_pages={self.mgr.total_pages}")
                self.preempt_to(n_active - 1)
                plan, spec = self._compose()
                if plan is None:
                    return 0
                if self._expandable:
                    self.mgr.ensure(int(plan.pos.max() + plan.width))
        self.tick_width = plan.width
        if spec:
            rows = self._run_fused(plan, True)  # (B, k+1)
            return self._commit_spec(plan, rows)
        nxt = self._run_fused(plan, False)
        gen = 0
        self.mgr.advance([w.slot for w in plan.work],
                         [len(w.tokens) for w in plan.work])
        for w in plan.work:
            req = self.slot_req[w.slot]
            if w.kind == "prefill":
                req.fed += len(w.tokens)
                if w.completes:  # logit after the last prompt token
                    self._append(req, w.slot, int(nxt[w.slot]))
                    gen += 1
            else:
                self._append(req, w.slot, int(nxt[w.slot]))
                gen += 1
        return gen

    def _commit_spec(self, plan: sched.TickPlan, rows: np.ndarray) -> int:
        """Verify draft rows against the greedy argmax and commit the
        accepted prefix plus the bonus token, one token at a time (the
        sequential EOS / max_new / max_len checks apply mid-prefix); roll
        the rejected tail's pages back through the allocator."""
        gen = 0
        for w in plan.work:
            req = self.slot_req[w.slot]
            nv = int(plan.n_valid[w.slot])
            drafts = w.tokens[1:nv]
            a = 0
            while a < len(drafts) and int(drafts[a]) == int(rows[w.slot, a]):
                a += 1
            self.spec_proposed += len(drafts)
            self.spec_accepted += a
            for i in range(a + 1):  # accepted drafts + the bonus token
                self.mgr.advance([w.slot], [1])
                self._append(req, w.slot, int(rows[w.slot, i]))
                gen += 1
                if req.done:
                    break
            if self._paged and not req.done:
                # rejected tail: return its pages, keeping the span the
                # next verify tick must reserve anyway; stale entries in
                # kept pages self-heal (their pos_ids exceed every later
                # query position until sequentially overwritten)
                self.mgr.trim(w.slot, min(
                    int(self.mgr.pos[w.slot]) + self._spec_k + 1,
                    self.max_len))
        return gen

    @property
    def spec_accept_rate(self) -> float:
        """Fraction of proposed draft tokens verification accepted."""
        return (self.spec_accepted / self.spec_proposed
                if self.spec_proposed else 0.0)

    def _append(self, req: Request, slot: int, tok: int):
        req.out.append(tok)
        if (tok == self.eos or len(req.out) >= req.max_new
                or self.mgr.pos[slot] >= self.max_len - 1):
            req.done = True
            req.finish_tick = self.ticks
            self.finished.append(req)
            self.slot_req[slot] = None
            self.mgr.free(slot)

    # -- scheduler loop -------------------------------------------------------
    def step(self) -> bool:
        """One scheduler iteration (admit, then one fused tick); True while
        there is still work."""
        if not (self.queue or any(r is not None for r in self.slot_req)):
            return False
        t0 = time.perf_counter()
        admitted = self._admit()
        gen = self._tick()
        oldest = (float(self.ticks - min(r.submit_tick for r in self.queue))
                  if self.queue else 0.0)
        if self.on_tick:
            smp = TickSample(
                tick=self.ticks, queued=len(self.queue),
                active=sum(r is not None for r in self.slot_req),
                finished=len(self.finished), tokens=gen,
                tick_s=time.perf_counter() - t0, slots=self.B,
                admitted=admitted, oldest_wait=oldest,
                pages_free=self.mgr.free_pages)
            for cb in self.on_tick:
                cb(smp)
        self.ticks += 1
        return bool(self.queue or any(r is not None for r in self.slot_req))

    def run(self, max_ticks: int = 512) -> List[Request]:
        ticks = 0
        while ticks < max_ticks and self.step():
            ticks += 1
        return self.finished
