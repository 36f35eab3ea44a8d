"""The port's serving tier (``repro_torch.serve``) against the JAX package
on ``llama3.2-1b.reduced()`` in float32, the reference's parameters carried
across; and the stateful path on ``mamba2-780m.reduced()`` and
``zamba2-1.2b.reduced()`` (``ssm_chunk`` 32).

Discrete outputs are held equal: the page allocator's and the paged
manager's bookkeeping on the same churn, and the greedy tokens of the
engine, contiguous and paged, on ``tests/test_serve_paged.py``'s ``_outs``
workload. Speculation, preemption and resume are held to the port's own
greedy run. The clamp scenario (a decode row near ``max_len`` riding a
prefill tick: the reference's ``_row_update`` clamps the write start and
the padded tail overwrites live history, ROADMAP queue 3) is reproduced
token for token, fault included.

On the stateful path the engine's greedy tokens (prompts of 5, 32 and 64
tokens) equal the JAX engine's, with and without a preemption; the slot
axes the port's cache manager reads off each leaf's place in the tree equal
those the reference probes. Two prompt lengths that the reference's
stateful engine cannot serve fail in the port too (ROADMAP queue 3): 40
tokens (longer than ``ssm_chunk`` and not a multiple of it) raises
``ValueError`` where the reference's scan fails to reshape, and 2 tokens
(fewer than ``ssm_conv - 1``) leaves a conv state that the slot cannot take.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models.model import Model as JModel
from repro.serve import cache as jcache
from repro.serve import step as jstep
from repro.serve.engine import Engine as JEngine, Request as JRequest
from repro_torch.configs import registry
from repro_torch.control.telemetry import TickSample
from repro_torch.models.model import Model
from repro_torch.serve import (Engine, ExpandableKVCacheManager,
                               ExpandablePagedKVCacheManager, KVCacheManager,
                               PageAllocator, PagedKVCacheManager, Request,
                               make_prefill_step)
from repro_torch.serve.cache import tree_map

ARCH = "llama3.2-1b"


@pytest.fixture(scope="module")
def dense():
    """(cfg, JAX model, JAX params, the port's model on the CPU), float32."""
    jcfg = jregistry.get(ARCH).reduced().replace(dtype="float32")
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = registry.get(ARCH).reduced().replace(dtype="float32")
    return cfg, jm, jp, Model(cfg, device="cpu").load_reference(
        jax.device_get(jp))


def _prompt(cfg, rid, n=5):
    return ((np.arange(n) * 3 + rid * 7) % cfg.vocab_size).astype(np.int32)


def _outs(cfg, model, n_req=4, max_new=12, **kw):
    """test_serve_paged.py's workload on the port's engine."""
    kw.setdefault("batch_slots", 2)
    kw.setdefault("max_len", 64)
    kw.setdefault("eos_id", -1)
    kw.setdefault("warmup", False)
    eng = Engine(model, **kw)
    for rid in range(n_req):
        eng.submit(Request(rid, _prompt(cfg, rid), max_new=max_new))
    eng.run()
    return eng, {r.rid: tuple(r.out) for r in eng.finished}


@pytest.fixture(scope="module")
def ref_outs(dense):
    cfg, jm, jp, _ = dense
    eng = JEngine(jm, jp, batch_slots=2, max_len=64, eos_id=-1,
                  warmup=False)
    for rid in range(4):
        eng.submit(JRequest(rid, _prompt(cfg, rid), max_new=12))
    eng.run()
    return {r.rid: tuple(r.out) for r in eng.finished}


class TestPageAllocator:
    def test_alloc_free_roundtrip(self):
        al = PageAllocator(4)
        assert al.free_pages == 4 and al.used_pages == 0
        a = al.alloc(3)
        assert len(a) == 3 and len(set(a)) == 3
        al.free(a[:2])
        assert al.free_pages == 3
        b = al.alloc(3)  # reuses the freed pages
        assert al.free_pages == 0 and sorted(a[2:] + b) == list(range(4))

    def test_exhaustion_and_double_free_raise(self):
        al = PageAllocator(3)
        pages = al.alloc(2)
        with pytest.raises(RuntimeError, match="exhausted"):
            al.alloc(2)
        al.free(pages)
        with pytest.raises(ValueError, match="double free"):
            al.free([pages[0]])
        with pytest.raises(ValueError, match="invalid page"):
            al.free([3])


def _churn(mgr):
    """A fixed churn of allocations, extensions, trims and frees; returns
    the bookkeeping after every step."""
    a = mgr.allocate(5)
    b = mgr.allocate(5)
    log = []
    for op in (lambda: mgr.advance([a], [20]),
               lambda: mgr.extend(b, 50),
               lambda: mgr.trim(b, 17),
               lambda: mgr.free(a),
               lambda: mgr.allocate(3),
               lambda: mgr.advance([b], [33]),
               lambda: mgr.trim(b, 0),
               lambda: mgr.free(b)):
        op()
        log.append((mgr.block_table.copy(), mgr.pos.copy(),
                    mgr.pages_in_use, mgr.peak_pages, mgr.free_pages,
                    mgr.recount_pages(), list(mgr.allocator._free),
                    mgr.free_slots, mgr.inverse_map()))
    return log


def test_paged_manager_bookkeeping_equals_reference(dense):
    _, jm, _, model = dense
    jmgr = jcache.PagedKVCacheManager(jm, slots=3, max_len=64, page_size=16)
    tmgr = PagedKVCacheManager(model, slots=3, max_len=64, page_size=16)
    for jl, tl in zip(_churn(jmgr), _churn(tmgr)):
        for x, y in zip(jl, tl):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    # freed and trimmed pages were invalidated on both sides
    np.testing.assert_array_equal(
        tmgr.pool["stack"]["pos_ids"].numpy(),
        np.asarray(jmgr.pool["stack"]["pos_ids"]))
    assert tmgr.pages_in_use == tmgr.allocator.used_pages == 1


def test_read_write_rows_round_trip(dense):
    """Preemption's payload: rows read through the block table come back
    onto other pages bit for bit, padded to the table's width."""
    _, _, _, model = dense
    mgr = PagedKVCacheManager(model, slots=2, max_len=32, page_size=8)
    s = mgr.allocate(5)
    mgr.extend(s, 12)
    g = torch.Generator().manual_seed(0)
    for name, leaf in mgr.pool["stack"].items():
        pages = torch.as_tensor(mgr.block_table[s, :2]).long()
        if name == "pos_ids":
            leaf[:, pages] = torch.arange(16, dtype=torch.int32).reshape(2, 8)
        else:
            leaf[:, pages] = torch.randn(leaf[:, pages].shape, generator=g)
    rows = mgr.read_rows([s])
    assert rows["stack"]["k"].shape[2] == 16  # two pages, not the full span
    other = mgr.allocate(0)
    mgr.restore(other, rows, 12)
    back = mgr.read_rows([other])
    for name in rows["stack"]:
        assert torch.equal(back["stack"][name], rows["stack"][name])
    assert mgr.pos[other] == 12 and mgr.slot_pages(other) == 2


@pytest.mark.parametrize("paged", [False, True])
def test_engine_tokens_equal_reference(dense, ref_outs, paged):
    cfg, _, _, model = dense
    eng, outs = _outs(cfg, model, paged=paged)
    assert outs == ref_outs
    assert eng.mgr.pages_in_use == eng.mgr.recount_pages() == 0


def test_paged_engine_sends_chunks(dense, ref_outs, monkeypatch):
    """The paged engine's tokens equal the JAX engine's with every call of
    the paged kernel in the chunk form: q (B, S, H, D), one table row per
    slot, pos (B, S); prefill ticks (S > 1) and decode ticks (S = 1)."""
    from repro_torch.models import attention as attn
    cfg, _, _, model = dense
    seen = []
    paged = attn.KERNELS["paged"]

    def spy(q, k, v, ids, bt, pos, **kw):
        assert q.dim() == 4 and bt.shape[0] == q.shape[0]
        assert tuple(pos.shape) == tuple(q.shape[:2])
        seen.append(q.shape[1])
        return paged(q, k, v, ids, bt, pos, **kw)

    monkeypatch.setitem(attn.KERNELS, "paged", spy)
    _, outs = _outs(cfg, model, paged=True)
    assert outs == ref_outs
    assert 1 in seen and max(seen) > 1


@pytest.mark.parametrize("paged", [False, True])
def test_speculate_accepts_the_greedy_prefix(dense, ref_outs, paged):
    cfg, _, _, model = dense
    eng, spec = _outs(cfg, model, paged=paged, speculate=3)
    assert spec == ref_outs, "speculative accepted prefix != greedy"
    assert eng.spec_accepted > 0 and eng.spec_accept_rate > 0.0
    with pytest.raises(ValueError, match="greedy"):
        Engine(model, batch_slots=2, max_len=64, temperature=0.7,
               speculate=2, warmup=False)


@pytest.fixture(scope="module")
def dense_bf16():
    """(cfg, the port's model on the CPU) in bfloat16, the reference's
    default dtype, the reference's parameters carried across."""
    jp = JModel(jregistry.get(ARCH).reduced()).init(jax.random.PRNGKey(0))
    cfg = registry.get(ARCH).reduced()
    return cfg, Model(cfg, device="cpu").load_reference(jax.device_get(jp))


@pytest.mark.parametrize("paged", [False, True])
def test_speculate_accepts_the_greedy_prefix_bf16(dense_bf16, paged):
    """The reference's contract in its own dtype (test_serve_paged.py):
    speculate=3 serves the greedy streams of the same traffic."""
    cfg, model = dense_bf16
    _, greedy = _outs(cfg, model, paged=paged)
    eng, spec = _outs(cfg, model, paged=paged, speculate=3)
    assert spec == greedy, "speculative accepted prefix != greedy (bf16)"
    assert eng.spec_accepted > 0


def verify_against_decode(engine, k=3):
    """From an engine whose next tick is all-decode: the logits (B, k + 1,
    V) of one verify tick whose drafts are greedy's next k tokens, and of
    the k + 1 decode ticks it stands for, stacked the same way (the cache
    restored between the two), and the live slots."""
    plan, _ = engine._compose()
    assert plan.width == 1
    live = [w.slot for w in plan.work]
    if engine._paged:
        for slot in live:
            engine.mgr.extend(slot, int(engine.mgr.pos[slot]) + k + 1)
        cache = engine.mgr.pool["stack"]
    else:
        cache = engine.mgr.cache["stack"]
    saved = {name: v.clone() for name, v in cache.items()}
    step = (plan.n_valid > 0).astype(np.int32)
    rows, toks = [], plan.tokens.copy()
    greedy = np.zeros((plan.tokens.shape[0], k + 1), np.int32)
    for j in range(k + 1):
        logits = engine.step_logits(toks, plan.pos + j * step, plan.n_valid)
        rows.append(logits)
        greedy[:, j] = toks[:, 0]
        toks = logits.argmax(-1).to(torch.int32).cpu().numpy()
    for name, v in saved.items():
        cache[name].copy_(v)
    verify = engine.step_logits(greedy, plan.pos, step * (k + 1))
    return verify, torch.cat(rows, dim=1), live


@pytest.mark.parametrize("paged", [False, True])
def test_verify_rows_take_their_decode_rows_arithmetic(dense_bf16, paged):
    cfg, model = dense_bf16
    eng = Engine(model, batch_slots=3, max_len=64, eos_id=-1, warmup=False,
                 paged=paged, prefill_chunk=32)
    for rid, n in enumerate((5, 20)):
        eng.submit(Request(rid, _prompt(cfg, rid, n), max_new=16))
    eng.step()
    verify, rows, live = verify_against_decode(eng)
    assert torch.equal(verify[live], rows[live])


def test_short_chunks_run_by_column(dense, monkeypatch):
    """A decode chunk of 2..16 rows takes its MLP products and norm means
    a column at a time; one token and a wider chunk take them whole."""
    from repro_torch.models import layers as L
    cfg, _, _, model = dense
    seen = []
    columns = L.columns
    monkeypatch.setattr(L, "columns", lambda x, cols: seen.append(
        (x.shape[1], cols)) or columns(x, cols))
    for S in (1, 2, 16, 17):
        cache = model.cache(2, 64)
        model.decode(torch.zeros((2, S), dtype=torch.long), cache, 0)
    split = [w for w, c in seen if c]
    # per layer: ln1's and ln2's means and the gate, up and down products;
    # the final norm
    assert cfg.mlp_type == "swiglu"
    assert split == [S for S in (2, 16) for _ in range(5 * cfg.num_layers + 1)]


@pytest.mark.parametrize("paged", [False, True])
def test_preempt_and_resume_equal_no_preemption(dense, paged):
    cfg, _, _, model = dense
    _, ref = _outs(cfg, model, n_req=2, max_new=16, paged=paged)
    eng = Engine(model, batch_slots=2, max_len=64, eos_id=-1, warmup=False,
                 paged=paged)
    for rid in range(2):
        eng.submit(Request(rid, _prompt(cfg, rid), max_new=16))
    for _ in range(4):
        eng.step()
    pages_before = eng.mgr.pages_in_use
    assert eng.preempt_to(1) == 1
    held = eng.pool.put_pages(eng.queue[0].rid)
    assert held >= 1 and eng.pool.pages_held == held
    assert eng.mgr.pages_in_use == pages_before - held
    eng.run()
    assert {r.rid: tuple(r.out) for r in eng.finished} == ref
    assert eng.pool.pages_held == 0 and eng.preempts == 1
    drained = Engine(model, batch_slots=2, max_len=64, eos_id=-1,
                     warmup=False, paged=paged)
    drained.submit(Request(9, _prompt(cfg, 9), max_new=4))
    drained.step()
    assert [r.rid for r in drained.drain()] == [9]
    assert drained.mgr.pages_in_use == 0 and 9 in drained.pool


def _clamp_run(engine, request_cls, cfg):
    """Request A (6-token prompt, 25 new) alone for 20 ticks, then B
    (20-token prompt, 3 new): B's prefill ticks are 8 wide, and A, decoding
    near max_len = 32, rides them."""
    a = request_cls(0, _prompt(cfg, 0, 6), max_new=25)
    engine.submit(a)
    for _ in range(20):
        engine.step()
    engine.submit(request_cls(1, _prompt(cfg, 1, 20), max_new=3))
    engine.run()
    return {r.rid: tuple(r.out) for r in engine.finished}


def test_clamp_scenario_reproduces_the_reference(dense):
    cfg, jm, jp, model = dense
    kw = dict(batch_slots=2, max_len=32, prefill_chunk=8, eos_id=-1,
              warmup=False)
    want = _clamp_run(JEngine(jm, jp, **kw), JRequest, cfg)
    alone = _outs(cfg, model, n_req=0, **kw)[0]
    alone.submit(Request(0, _prompt(cfg, 0, 6), max_new=25))
    alone.run()
    alone = tuple(alone.finished[0].out)
    for paged in (False, True):
        got = _clamp_run(Engine(model, paged=paged, **kw), Request, cfg)
        assert got == want, paged
    # the fault: A's stream departs from A alone from its 22nd token on
    first = next(i for i, (x, y) in enumerate(zip(got[0], alone)) if x != y)
    assert first == 21 and got[0][:21] == alone[:21]


def test_tick_samples_and_prefill_step(dense):
    cfg, jm, jp, model = dense
    seen = []
    eng = Engine(model, batch_slots=2, max_len=64, eos_id=-1, paged=True)
    eng.on_tick.append(seen.append)
    eng.submit(Request(0, _prompt(cfg, 0, 20), max_new=3))
    eng.run()
    assert len(seen) == eng.ticks and all(isinstance(s, TickSample)
                                          for s in seen)
    assert [s.tokens for s in seen] == [0, 1, 1, 1]  # 16 + 4 prompt, 3 new
    assert seen[0].admitted == 1 and seen[-1].finished == 1
    toks = np.stack([_prompt(cfg, r, 12) for r in range(2)])
    jl, _ = jstep.make_prefill_step(jm, 16)(jp, {"tokens": toks})
    tl, cache = make_prefill_step(model, 16)({"tokens": toks})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    assert cache["stack"]["k"].shape == (2, 2, 16, 2, 16)


def test_unported_paths_raise(dense):
    cfg, _, _, model = dense
    # the expandable managers are ported: the engine builds them
    assert isinstance(Engine(model, expandable=True, warmup=False).mgr,
                      ExpandableKVCacheManager)
    assert isinstance(Engine(model, expandable=True, paged=True,
                             warmup=False).mgr, ExpandablePagedKVCacheManager)
    # the sliding-window ring is ported: a windowed model serves
    swa = Model(cfg.replace(sliding_window=8), device="cpu")
    Engine(swa, max_len=64, warmup=False)


# --- the stateful path (ssm and hybrid families) ------------------------------

STATEFUL_PROMPTS = (5, 32, 64)
STATEFUL_KW = dict(batch_slots=2, max_len=96, eos_id=-1, warmup=False)


@pytest.fixture(scope="module", params=["mamba2-780m", "zamba2-1.2b"])
def stateful(request):
    """(cfg, JAX model, JAX params, the port's model, the JAX engine's
    greedy tokens), float32."""
    jcfg = jregistry.get(request.param).reduced().replace(dtype="float32")
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = registry.get(request.param).reduced().replace(dtype="float32")
    model = Model(cfg, device="cpu").load_reference(jax.device_get(jp))
    eng = JEngine(jm, jp, **STATEFUL_KW)
    for rid, n in enumerate(STATEFUL_PROMPTS):
        eng.submit(JRequest(rid, _prompt(cfg, rid, n), max_new=10))
    eng.run()
    return cfg, jm, jp, model, {r.rid: tuple(r.out) for r in eng.finished}


def _stateful_run(cfg, model, preempt_at=None):
    eng = Engine(model, **STATEFUL_KW)
    for rid, n in enumerate(STATEFUL_PROMPTS):
        eng.submit(Request(rid, _prompt(cfg, rid, n), max_new=10))
    ticks = 0
    while eng.step():
        ticks += 1
        if ticks == preempt_at:
            assert eng.preempt_to(1) == 1
    return eng, {r.rid: tuple(r.out) for r in eng.finished}


def test_stateful_engine_tokens_equal_reference(stateful):
    cfg, _, _, model, want = stateful
    eng, got = _stateful_run(cfg, model)
    assert got == want
    assert eng.mgr.pages_in_use == eng.mgr.recount_pages() == 0


def test_stateful_preempt_and_resume_equal_reference(stateful):
    """A slot's recurrent state (and the hybrid's K/V) parks in the host
    pool and comes back into whichever slot is free: the same tokens."""
    cfg, _, _, model, want = stateful
    eng, got = _stateful_run(cfg, model, preempt_at=4)
    assert got == want
    assert eng.preempts == 1 and eng.pool.pages_held == 0


def _assert_axis(path, leaf, ax, want):
    assert ax == want and leaf.shape[ax] == 3, path


def test_stateful_slot_axes_equal_the_reference_probe(stateful):
    cfg, jm, _, model, _ = stateful
    probed = jcache.KVCacheManager(jm, slots=3, max_len=16,
                                   alloc=False).batch_axes
    mgr = KVCacheManager(model, slots=3, max_len=16)
    tree_map(_assert_axis, mgr.cache, mgr.axes,
             jax.tree_util.tree_map(int, probed))
    rows = mgr.read_rows([2])
    mgr.write_rows([0], rows)
    assert all(torch.equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(mgr.read_rows([0])),
        jax.tree_util.tree_leaves(rows)))


def test_stateful_prompt_length_faults_as_in_the_reference(stateful):
    cfg, jm, jp, model, _ = stateful
    for n, want_ref, want_port in ((40, TypeError, ValueError),
                                   (2, ValueError, RuntimeError)):
        ref = JEngine(jm, jp, **STATEFUL_KW)
        ref.submit(JRequest(0, _prompt(cfg, 0, n), max_new=4))
        with pytest.raises(want_ref):
            ref.run()
        eng = Engine(model, **STATEFUL_KW)
        eng.submit(Request(0, _prompt(cfg, 0, n), max_new=4))
        with pytest.raises(want_port, match="ssm_chunk" if n == 40
                           else "shape"):
            eng.run()


def test_stateful_path_refuses_paged_and_speculate(stateful):
    _, _, _, model, _ = stateful
    with pytest.raises(ValueError, match="ragged"):
        Engine(model, paged=True, **STATEFUL_KW)
    with pytest.raises(ValueError, match="ragged"):
        Engine(model, speculate=2, **STATEFUL_KW)
