"""The port's expandable cache managers (``repro_torch.serve.cache``'s
``ExpandableKVCacheManager`` and ``ExpandablePagedKVCacheManager``) and the
engine's ``expandable=True`` against the JAX package, on
``llama3.2-1b.reduced()`` in float32 with the reference's parameters carried
across.

The reference's six expandable tests are mirrored
(``tests/test_serve_cache.py::TestExpandableKVCacheManager``,
``tests/test_serve_paged.py::TestExpandablePagedGrowth``,
``tests/test_serve_engine.py::test_resume_across_expandable_growth``), each
held to the reference's managers and engine on the same calls: equal
``capacity`` and ``grows`` after every ``ensure``, equal leaf shapes and
``pos_ids`` after a growth, block tables that only widen and equal the
reference's tick by tick, and greedy tokens equal to the reference
engine's. A request parked in the host pool across a growth resumes with the
reference's tokens (the stashed rows padded out to the grown shapes), on
both kinds of cache. The hybrid family (zamba2) grows its attention leaves
and keeps its SSM states; a sliding-window ring shorter than the initial
capacity is left alone, and the paged manager refuses a window shorter than
``max_len``, as the reference's does.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models.model import Model as JModel
from repro.serve import cache as jcache
from repro.serve.engine import Engine as JEngine, Request as JRequest
from repro_torch.configs import registry
from repro_torch.models.model import Model
from repro_torch.serve import (Engine, ExpandableKVCacheManager,
                               ExpandablePagedKVCacheManager, Request)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small ops: with several test processes sharing the cores, torch
    runs these on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(arch, seed=0, **replace):
    """(cfg, JAX model, JAX params, the port's model on the CPU), float32."""
    kw = dict(dtype="float32", **replace)
    jcfg = jregistry.get(arch).reduced().replace(**kw)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    cfg = registry.get(arch).reduced().replace(**kw)
    return cfg, jm, jp, Model(cfg, device="cpu").load_reference(
        jax.device_get(jp))


@pytest.fixture(scope="module")
def dense():
    return _pair("llama3.2-1b")


def _shapes(tree):
    return [tuple(x.shape) for x in jax.tree_util.tree_leaves(tree)]


def _prompt(cfg, rid, n=5):
    return ((np.arange(n) * 3 + rid * 7) % cfg.vocab_size).astype(np.int32)


def _outs(eng, cfg, R, n_req=3, max_new=20, n=5):
    for rid in range(n_req):
        eng.submit(R(rid, _prompt(cfg, rid, n), max_new=max_new))
    eng.run()
    return {r.rid: tuple(r.out) for r in eng.finished}


# --- TestExpandableKVCacheManager --------------------------------------------

def test_grows_by_doubling_to_max_len(dense):
    _, jm, _, model = dense
    ref = jcache.ExpandableKVCacheManager(jm, slots=2, max_len=64,
                                          initial_len=8)
    mgr = ExpandableKVCacheManager(model, slots=2, max_len=64, initial_len=8)
    assert mgr.capacity == ref.capacity == 8
    assert _shapes(mgr.cache) == _shapes(ref.cache)
    for need in (8, 9, 50):  # 50 doubles twice in one call
        ref.ensure(need)
        mgr.ensure(need)
        assert (mgr.capacity, mgr.grows) == (ref.capacity, ref.grows)
        assert _shapes(mgr.cache) == _shapes(ref.cache)
    assert (mgr.capacity, mgr.grows) == (64, 2)
    for m in (ref, mgr):
        with pytest.raises(ValueError):
            m.ensure(65)


def test_growth_pads_pos_ids_invalid(dense):
    _, jm, _, model = dense
    ref = jcache.ExpandableKVCacheManager(jm, slots=2, max_len=32,
                                          initial_len=8)
    mgr = ExpandableKVCacheManager(model, slots=2, max_len=32, initial_len=8)
    ref.cache["stack"]["pos_ids"] = (
        ref.cache["stack"]["pos_ids"].at[..., :2].set(0))
    mgr.cache["stack"]["pos_ids"][..., :2] = 0
    mgr.cache["stack"]["k"][..., :2, :, :] = 1.5
    ref.ensure(16)
    mgr.ensure(16)
    ids = mgr.cache["stack"]["pos_ids"].numpy()
    np.testing.assert_array_equal(ids, np.asarray(ref.cache["stack"]
                                                  ["pos_ids"]))
    assert ids.shape[-1] == 16
    assert (ids[..., :2] == 0).all() and (ids[..., 8:] == -1).all()
    k = mgr.cache["stack"]["k"]
    assert (k[..., :2, :, :] == 1.5).all() and (k[..., 8:, :, :] == 0).all()


def test_engine_results_match_fixed_cache(dense):
    cfg, jm, jp, model = dense
    prompt = np.arange(5) % cfg.vocab_size
    ref = JEngine(jm, jp, batch_slots=2, max_len=64, eos_id=-1,
                  warmup=False, expandable=True)
    ref.submit(JRequest(0, prompt, max_new=6))
    want = ref.run()[0].out
    for expandable in (False, True):
        eng = Engine(model, batch_slots=2, max_len=64, eos_id=-1,
                     expandable=expandable, warmup=False)
        eng.submit(Request(0, prompt, max_new=6))
        assert eng.run()[0].out == want


# --- TestExpandablePagedGrowth -----------------------------------------------

def test_growth_widens_tables_without_relocating_pages(dense):
    _, jm, _, model = dense
    kw = dict(slots=2, max_len=64, initial_len=16, page_size=16)
    ref = jcache.ExpandablePagedKVCacheManager(jm, **kw)
    mgr = ExpandablePagedKVCacheManager(model, **kw)
    assert mgr.capacity == ref.capacity == 16
    assert mgr.block_table.shape[1] == 1
    s = mgr.allocate(5)
    assert s == ref.allocate(5)
    live = int(mgr.block_table[s, 0])
    for m in (ref, mgr):
        m.ensure(40)
    # one ensure doubles twice and counts one growth, as the reference's
    assert (mgr.capacity, mgr.grows) == (ref.capacity, ref.grows) == (64, 1)
    np.testing.assert_array_equal(mgr.block_table, ref.block_table)
    assert mgr.block_table[s, 0] == live  # a live page never moves
    assert (mgr.block_table[:, 1:] == mgr.null_page).all()
    assert mgr.pages_in_use == mgr.recount_pages() == 1
    for m in (ref, mgr):
        m.advance([s], [40])  # claim across the grown width
    np.testing.assert_array_equal(mgr.block_table, ref.block_table)
    assert mgr.block_table[s, 0] == live and mgr.slot_pages(s) == 3
    assert mgr.peak_pages == ref.peak_pages == 3
    # the pool is sized for max_len up front and never reallocated
    assert mgr.pool["stack"]["k"].shape[1] == mgr.total_pages + 1 == 9


def test_engine_results_match_contiguous(dense):
    """The paged expandable engine, stepped beside the reference's, with
    prompts and generations long enough to double the capacity twice: the
    block tables widen and equal the reference's after every tick, and the
    tokens equal the reference engine's."""
    cfg, jm, jp, model = dense
    kw = dict(batch_slots=2, max_len=256, eos_id=-1, warmup=False,
              paged=True, expandable=True)
    ref = JEngine(jm, jp, **kw)
    eng = Engine(model, **kw)
    for rid in range(3):
        p = _prompt(cfg, rid, 30 + 20 * rid)
        ref.submit(JRequest(rid, p, max_new=60))
        eng.submit(Request(rid, p, max_new=60))
    widths = []
    while True:
        more, ref_more = eng.step(), ref.step()
        np.testing.assert_array_equal(eng.mgr.block_table,
                                      ref.mgr.block_table)
        assert (eng.mgr.capacity, eng.mgr.grows, eng.mgr.pages_in_use,
                eng.mgr.peak_pages) == (ref.mgr.capacity, ref.mgr.grows,
                                        ref.mgr.pages_in_use,
                                        ref.mgr.peak_pages)
        assert eng.mgr.pages_in_use == eng.mgr.recount_pages()
        widths.append(eng.mgr.block_table.shape[1])
        assert more == ref_more
        if not more:
            break
    assert widths == sorted(widths) and widths[-1] > widths[0]
    assert ({r.rid: r.out for r in eng.finished}
            == {r.rid: r.out for r in ref.finished})
    assert _outs(JEngine(jm, jp, batch_slots=2, max_len=256, eos_id=-1,
                         warmup=False), cfg, JRequest, n=30) == _outs(
        Engine(model, **kw), cfg, Request, n=30)


# --- resume across a growth ---------------------------------------------------

def test_resume_across_expandable_growth(dense):
    """The reference's test: preempt after 2 ticks, then resume beside a
    second request (max_len 64, so the capacity does not grow)."""
    cfg, jm, jp, model = dense
    prompt = np.arange(5) % cfg.vocab_size
    other = (np.arange(9) * 3 + 2) % cfg.vocab_size
    got = {}
    for E, R, m in ((JEngine, JRequest, (jm, jp)), (Engine, Request,
                                                     (model,))):
        solo = E(*m, batch_slots=2, max_len=64, eos_id=-1, warmup=False,
                 expandable=True)
        solo.submit(R(0, prompt, max_new=12))
        alone = solo.run()[0].out
        eng = E(*m, batch_slots=2, max_len=64, eos_id=-1, warmup=False,
                expandable=True)
        eng.submit(R(0, prompt, max_new=12))
        for _ in range(2):
            eng.step()
        eng.preempt_to(0)
        eng.submit(R(1, other, max_new=12))
        done = {r.rid: r for r in eng.run()}
        assert done[0].out == alone and done[0].preempts == 1
        got[E] = {rid: r.out for rid, r in done.items()}
    assert got[Engine] == got[JEngine]


@pytest.mark.parametrize("paged", [False, True])
def test_resume_while_the_cache_grows(dense, paged):
    """A request parks in the host pool at capacity 64 and stays parked
    (``admit_cap`` 0) while a long prompt doubles the capacity to 128: its
    rows are restored into the grown cache, padded (``pos_ids`` -1), and
    its tokens equal the reference engine's in the same traffic and those
    of a run with no preemption."""
    cfg, jm, jp, model = dense
    kw = dict(batch_slots=2, max_len=256, eos_id=-1, warmup=False,
              expandable=True, paged=paged)
    short, long_ = _prompt(cfg, 0, 10), _prompt(cfg, 1, 90)
    outs = {}
    for E, R, m in ((JEngine, JRequest, (jm, jp)), (Engine, Request,
                                                     (model,))):
        eng = E(*m, **kw)
        eng.submit(R(0, short, max_new=30, priority=0))
        eng.submit(R(1, long_, max_new=30, priority=1))
        for _ in range(3):
            eng.step()
        assert eng.mgr.capacity == 64
        assert eng.preempt_to(1) == 1 and 0 in eng.pool
        eng.admit_cap = 0
        while eng.mgr.capacity == 64:
            eng.step()
        assert 0 in eng.pool and eng.mgr.grows == 1
        eng.admit_cap = None
        outs[E] = {r.rid: r.out for r in eng.run()}
        assert eng.pool.pages_held == 0
    assert outs[Engine] == outs[JEngine]
    plain = Engine(model, **kw)
    for rid, p in ((0, short), (1, long_)):
        plain.submit(Request(rid, p, max_new=30))
    assert {r.rid: r.out for r in plain.run()}[0] == outs[Engine][0]


# --- the hybrid family and the sliding window ---------------------------------

def test_hybrid_grows_attention_and_keeps_ssm_state():
    """zamba2: the shared attention's K/V and pos_ids grow, the mamba
    layers' SSM and conv states keep their shapes, as in the reference;
    the stateful engine's tokens (its prefill sized by the capacity) equal
    the reference engine's."""
    cfg, jm, jp, model = _pair("zamba2-1.2b")
    ref = jcache.ExpandableKVCacheManager(jm, slots=2, max_len=128,
                                          initial_len=32)
    mgr = ExpandableKVCacheManager(model, slots=2, max_len=128,
                                   initial_len=32)
    before = {k: tuple(v.shape) for k, v in mgr.cache["groups"].items()}
    ref.ensure(70)
    mgr.ensure(70)
    assert (mgr.capacity, mgr.grows) == (ref.capacity, ref.grows) == (128, 1)
    assert _shapes(mgr.cache) == _shapes(ref.cache)
    assert {k: tuple(v.shape) for k, v in mgr.cache["groups"].items()} \
        == before
    assert mgr.cache["shared_attn"]["k"].shape[2] == 128
    kw = dict(batch_slots=2, max_len=128, eos_id=-1, warmup=False,
              expandable=True)
    want = _outs(JEngine(jm, jp, **kw), cfg, JRequest, n_req=2, max_new=40,
                 n=32)
    eng = Engine(model, **kw)
    assert _outs(eng, cfg, Request, n_req=2, max_new=40, n=32) == want
    assert eng.mgr.grows == 1


def test_window_ring_is_left_alone_and_paged_refuses():
    cfg, jm, jp, model = _pair("mixtral-8x7b", seed=1, sliding_window=8)
    ref = jcache.ExpandableKVCacheManager(jm, slots=2, max_len=64,
                                          initial_len=16)
    mgr = ExpandableKVCacheManager(model, slots=2, max_len=64,
                                   initial_len=16)
    shapes = _shapes(mgr.cache)
    ref.ensure(40)
    mgr.ensure(40)
    assert (mgr.capacity, mgr.grows) == (ref.capacity, ref.grows) == (64, 1)
    assert _shapes(mgr.cache) == shapes == _shapes(ref.cache)
    with pytest.raises(ValueError, match="sliding_window"):
        jcache.ExpandablePagedKVCacheManager(jm, 2, 64)
    with pytest.raises(ValueError, match="sliding_window"):
        ExpandablePagedKVCacheManager(model, 2, 64)
    with pytest.raises(ValueError, match="sliding_window"):
        Engine(model, max_len=64, paged=True, expandable=True,
               prefill_chunk=8, warmup=False)


@pytest.mark.parametrize("paged", [False, True])
def test_a_tick_past_max_len_raises_as_in_the_reference(dense, paged):
    """A slot decoding near ``max_len`` beside a 16-token prefill chunk:
    the tick asks for more than ``max_len`` and the engine raises
    ``ValueError`` in both packages (where the fixed-size cache clamps the
    write, ROADMAP queue 3)."""
    cfg, jm, jp, model = dense
    for E, R, m in ((JEngine, JRequest, (jm, jp)), (Engine, Request,
                                                     (model,))):
        eng = E(*m, batch_slots=2, max_len=64, eos_id=-1, warmup=False,
                expandable=True, paged=paged)
        eng.submit(R(0, _prompt(cfg, 0), max_new=60))
        while eng.mgr.pos[0] < 50:
            eng.step()
        eng.submit(R(1, _prompt(cfg, 1, 20), max_new=4))
        with pytest.raises(ValueError, match="needs"):
            eng.run()
