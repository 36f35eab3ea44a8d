"""The port's MLA (``repro_torch.models.attention.mla_*``) and the deepseek-v2
family against the JAX package on ``deepseek-v2-236b.reduced()`` (a dense
block and an MoE block of 8 experts top-2 plus a shared expert; q_lora 32,
kv_lora 32, heads of nope 16 + rope 8, v 16), the reference's parameters
carried across.

In float32 the attention functions (``mla_apply``, the ragged
``mla_decode`` at S = 1 and on a chunk with padded tails, the seeded cache)
agree with the JAX functions within 1e-5, as do the model's ``apply``,
``prefill`` and decode; the paged decode (the compressed rows in pages
behind a block table) equals the contiguous one bit for bit. The engine's
greedy and ``speculate=3`` tokens equal the JAX engine's in each mode,
contiguous and paged (speculation serves the greedy streams except where a
verify chunk overflows an expert's capacity, as in the reference); a
preemption and its resume change nothing. The reference's ``_row_update``
clamp fault (a decode row near ``max_len`` riding a prefill tick lands
shifted and its padded tail overwrites live history, ROADMAP queue 3)
reaches MLA's decode too: both packages lose the same history, and the
engines' tokens stay equal. In bfloat16 the model is within 0.06 of the
reference's with top-1 agreement above 0.95 where the routing makes no
choice (every expert takes every token): a top-2 router's near-tie
flipped by bf16 rounding is a discrete change.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import attention as jattn
from repro.models.model import Model as JModel
from repro.serve.engine import Engine as JEngine, Request as JRequest
from repro.sharding.plan import make_plan
from repro_torch.configs import registry
from repro_torch.models import attention as attn
from repro_torch.models import params as pm
from repro_torch.models.model import Model
from repro_torch.serve import Engine, Request

ARCH = "deepseek-v2-236b"
TOL = 1e-5
BF16_ATOL, TOP1 = 0.06, 0.95


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small ops: with several test processes sharing the cores, torch
    runs these on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(dtype="float32"):
    kw = dict(dtype=dtype, param_dtype="float32")
    jcfg = jregistry.get(ARCH).reduced().replace(**kw)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = registry.get(ARCH).reduced().replace(**kw)
    return jcfg, jm, jp, Model(cfg, device="cpu").load_reference(
        jax.device_get(jp))


@pytest.fixture(scope="module")
def models():
    """(JAX config, JAX model, its params, the port's model), float32."""
    return _pair()


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _layer(models):
    """One MLA layer's parameters on both sides (the dense block's)."""
    jcfg, _, jp, model = models
    return (jcfg, make_plan(jcfg), jp["blocks"]["dense0"]["attn"],
            model.cfg, model.params["blocks"]["dense0"]["attn"])


def _leaves(jc, tc):
    for key in ("c_kv", "k_rope"):
        _close(tc[key].numpy(), jc[key])
    np.testing.assert_array_equal(tc["pos_ids"].numpy(),
                                  np.asarray(jc["pos_ids"]))


def test_param_tree_and_cache_are_the_references(models):
    jcfg, jm, jp, model = models
    want = jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                  jax.device_get(jp))
    got = pm.tree_map(lambda t: tuple(t.shape), model.weights())
    assert got == pm.tree_map(lambda s: s, want)
    assert set(got["blocks"]["dense0"]["attn"]) == {
        "q_down", "q_norm", "q_up", "kv_down", "kv_norm", "k_up", "v_up",
        "wo"}
    # the compressed caches' layout; the norms stay in float32 in bf16
    jc = jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                jm.cache(3, 16, abstract=True))
    tc = pm.tree_map(lambda t: tuple(t.shape), model.cache(3, 16))
    assert tc == pm.tree_map(lambda s: s, jc)
    bf = Model(model.cfg.replace(dtype="bfloat16"), device="cpu").init(0)
    a = bf.params["blocks"]["stack"]["attn"]
    assert a["k_up"].dtype == a["q_down"].dtype == torch.bfloat16
    assert a["q_norm"].dtype == a["kv_norm"].dtype == torch.float32


def test_mla_apply_equals_reference(models):
    jcfg, plan, jpl, cfg, tpl = _layer(models)
    x = _x((2, 12, cfg.d_model))
    jo, (jc, jk) = jattn.mla_apply(jpl, jnp.asarray(x), jcfg, plan)
    to, (tc, tk) = attn.mla_apply(tpl, torch.from_numpy(x), cfg)
    _close(to.numpy(), jo)
    _close(tc.numpy(), jc)
    _close(tk.numpy(), jk)


@pytest.mark.parametrize("S,n_valid", [(1, None), (4, [4, 2])])
def test_mla_decode_and_seeded_cache_equal_reference(models, S, n_valid):
    """A ragged prefill seeds the cache (rows of 10 and 7 real tokens),
    then a decode step at per-row positions: S = 1, and a chunk of 4 whose
    second row holds 2 real tokens (its padded tail records -1)."""
    jcfg, plan, jpl, cfg, tpl = _layer(models)
    x = _x((2, 10, cfg.d_model))
    lengths = np.array([10, 7], np.int32)
    _, jkv = jattn.mla_apply(jpl, jnp.asarray(x), jcfg, plan)
    _, tkv = attn.mla_apply(tpl, torch.from_numpy(x), cfg)
    jc = jattn.mla_seed_cache(
        jattn.mla_cache_init(jcfg, plan, 2, 24, jnp.float32), jkv, 10,
        lengths=jnp.asarray(lengths))
    tc = attn.mla_seed_cache(
        attn.mla_cache_init(cfg, 2, 24, torch.float32), tkv, 10,
        lengths=lengths)
    _leaves(jc, tc)
    xs = _x((2, S, cfg.d_model), seed=2)
    nv = None if n_valid is None else np.asarray(n_valid, np.int32)
    jo, jc = jattn.mla_decode(jpl, jnp.asarray(xs), jc, jnp.asarray(lengths),
                              jcfg, plan,
                              n_valid=None if nv is None else jnp.asarray(nv))
    to, tc = attn.mla_decode(tpl, torch.from_numpy(xs), tc, lengths, cfg,
                             n_valid=nv)
    _close(to.numpy(), jo)
    _leaves(jc, tc)


@pytest.mark.parametrize("S", [1, 5])
def test_paged_decode_equals_contiguous(models, S):
    """The same step on the contiguous rows and on a page pool holding
    them behind permuted block tables: equal outputs bit for bit, and the
    chunk written to the pages the tables name."""
    _, _, _, cfg, tpl = _layer(models)
    B, ps, n = 2, 4, 6
    T = ps * n
    g = torch.Generator().manual_seed(3)
    cont = attn.mla_cache_init(cfg, B, T, torch.float32)
    cont["c_kv"].normal_(generator=g)
    cont["k_rope"].normal_(generator=g)
    cont["pos_ids"][0, :13] = torch.arange(13, dtype=torch.int32)
    cont["pos_ids"][1, :7] = torch.arange(7, dtype=torch.int32)
    bt = torch.randperm(B * n, generator=g).reshape(B, n).int()
    pool = {k: torch.empty((B * n + 1, ps) + v.shape[2:], dtype=v.dtype)
            for k, v in cont.items()}
    for name, leaf in cont.items():
        pool[name][bt.long()] = leaf.reshape(B, n, ps, *leaf.shape[2:])
    x = torch.from_numpy(_x((B, S, cfg.d_model), seed=4))
    pos = torch.tensor([13, 7], dtype=torch.int32)
    nv = torch.tensor([S, max(S - 2, 1)], dtype=torch.int32)
    oc, cont = attn.mla_decode(tpl, x, cont, pos, cfg, n_valid=nv)
    op, pool = attn.mla_decode(tpl, x, pool, pos, cfg, n_valid=nv,
                               block_table=bt, null_page=B * n)
    assert torch.equal(oc, op)
    for name, leaf in cont.items():
        got = pool[name][bt.long()].reshape(leaf.shape)
        assert torch.equal(got, leaf), name


def test_model_equals_reference(models):
    """The model's apply, prefill (right-padded, ``lengths``) and a ragged
    extend and decode step within 1e-5, every cache leaf too."""
    _, jm, jp, model = models
    toks = _tokens((2, 18), seed=8)
    jl, _ = jm.apply(jp, {"tokens": jnp.asarray(toks)})
    tl, _ = model.apply({"tokens": toks})
    _close(tl.numpy(), jl)
    lengths = np.array([8, 6], np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :8])}, max_len=24,
                        lengths=jnp.asarray(lengths))
    tl, tc = model.prefill({"tokens": toks[:, :8]}, max_len=24,
                           lengths=lengths)
    _close(tl.numpy(), jl)
    assert set(tc) == {"stack", "dense0"}
    steps = [(toks[:, 8:16], lengths, np.array([8, 5], np.int32)),
             (toks[:, 16:17], np.array([16, 11], np.int32), None)]
    for chunk, pos, nv in steps:
        jl, jc = jm.decode(jp, jnp.asarray(chunk), jc, jnp.asarray(pos),
                           n_valid=None if nv is None else jnp.asarray(nv))
        tl, tc = model.decode(chunk, tc, pos, n_valid=nv)
        _close(tl.numpy(), jl)
    for key in ("dense0", "stack"):
        _leaves(jc[key], tc[key])


def test_bf16_within_tolerance():
    """The working type, within 0.06 of the reference with top-1 agreement
    above 0.95: ``mla_apply`` and a decode chunk, and the model with every
    expert taking every token (top-8 of 8, ample capacity). With top-2
    routing a router near-tie that bf16 rounding flips sends a token to
    another expert in one package, a discrete change (as
    ``tests/test_torch_moe.py`` treats a route that differs), so the bound
    is held where the routing makes no choice."""
    kw = dict(num_experts_per_tok=8, moe_capacity_factor=16.0)
    jcfg = jregistry.get(ARCH).reduced().replace(dtype="bfloat16", **kw)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    model = Model(registry.get(ARCH).reduced().replace(
        dtype="bfloat16", **kw), device="cpu").load_reference(
            jax.device_get(jp))

    def close(got, want):
        got, want = got.float().numpy(), np.asarray(want, np.float32)
        assert np.abs(got - want).max() <= BF16_ATOL
        return got, want

    plan, cfg = make_plan(jcfg), model.cfg
    jpl = jp["blocks"]["dense0"]["attn"]
    tpl = model.params["blocks"]["dense0"]["attn"]
    x = _x((2, 12, cfg.d_model))
    jo, jkv = jattn.mla_apply(jpl, jnp.asarray(x, jnp.bfloat16), jcfg, plan)
    to, tkv = attn.mla_apply(tpl, torch.from_numpy(x).bfloat16(), cfg)
    close(to, jo)
    jc = jattn.mla_seed_cache(jattn.mla_cache_init(
        jcfg, plan, 2, 16, jnp.bfloat16), jkv, 12)
    tc = attn.mla_seed_cache(attn.mla_cache_init(cfg, 2, 16, torch.bfloat16),
                             tkv, 12)
    xs = _x((2, 3, cfg.d_model), seed=2)
    jo, _ = jattn.mla_decode(jpl, jnp.asarray(xs, jnp.bfloat16), jc, 12,
                             jcfg, plan)
    to, _ = attn.mla_decode(tpl, torch.from_numpy(xs).bfloat16(), tc, 12,
                            cfg)
    close(to, jo)
    toks = _tokens((4, 32))
    jl, _ = jm.apply(jp, {"tokens": jnp.asarray(toks)})
    tl, _ = model.apply({"tokens": toks})
    got, want = close(tl, jl)
    assert (got.argmax(-1) == want.argmax(-1)).mean() > TOP1


# --- the engine --------------------------------------------------------------

PROMPTS = (5, 30, 9, 17)
ENGINE_KW = dict(batch_slots=2, max_len=64, eos_id=-1, warmup=False)


def _prompt(cfg, rid, n):
    return ((np.arange(n) * 3 + rid * 7) % cfg.vocab_size).astype(np.int32)


def _run(engine, request_cls, cfg, preempt_at=None):
    for rid, n in enumerate(PROMPTS):
        engine.submit(request_cls(rid, _prompt(cfg, rid, n), max_new=12))
    ticks = 0
    while engine.step():
        ticks += 1
        if ticks == preempt_at:
            assert engine.preempt_to(1) == 1
    return {r.rid: tuple(r.out) for r in engine.finished}


@pytest.fixture(scope="module")
def ref_outs(models):
    _, jm, jp, model = models
    return _run(JEngine(jm, jp, **ENGINE_KW), JRequest, model.cfg)


@pytest.mark.parametrize("paged", [False, True])
def test_engine_tokens_equal_reference(models, ref_outs, paged):
    model = models[3]
    eng = Engine(model, paged=paged, **ENGINE_KW)
    assert _run(eng, Request, model.cfg) == ref_outs
    if paged:  # the pool holds the compressed rows, a layer axis first
        pool = eng.mgr.pool["stack"]
        assert set(pool) == {"c_kv", "k_rope", "pos_ids"}
        assert pool["c_kv"].shape[1:] == (eng.mgr.total_pages + 1, 16,
                                          model.cfg.kv_lora_rank)


@pytest.mark.parametrize("paged", [False, True])
def test_speculate_and_preemption_equal_reference(models, ref_outs, paged):
    """``speculate=3`` serves the reference engine's speculative tokens in
    the same mode; contiguous, they are the greedy streams, while paged a
    verify chunk's routes overflow an expert's capacity and the
    reference's own speculative streams depart from greedy there (the
    capacity fault of ROADMAP queue 3, pinned below). A preemption and its
    resume serve the greedy streams."""
    _, jm, jp, model = models
    want = _run(JEngine(jm, jp, paged=paged, speculate=3, **ENGINE_KW),
                JRequest, model.cfg)
    eng = Engine(model, paged=paged, speculate=3, **ENGINE_KW)
    assert _run(eng, Request, model.cfg) == want
    assert eng.spec_accepted > 0
    assert (want == ref_outs) == (not paged)
    eng = Engine(model, paged=paged, **ENGINE_KW)
    assert _run(eng, Request, model.cfg, preempt_at=4) == ref_outs
    assert eng.preempts == 1


def _clamp_run(engine, request_cls, cfg):
    """Request A (6-token prompt, 25 new) alone for 20 ticks, then B
    (20-token prompt, 3 new): B's prefill ticks are 8 wide, and A, decoding
    near max_len = 32, rides them."""
    engine.submit(request_cls(0, _prompt(cfg, 0, 6), max_new=25))
    for _ in range(20):
        engine.step()
    engine.submit(request_cls(1, _prompt(cfg, 1, 20), max_new=3))
    engine.run()
    return {r.rid: tuple(r.out) for r in engine.finished}


def test_clamp_scenario_reproduces_the_reference(models):
    """The reference's fault, not intended behaviour, in both packages: a
    chunk row at pos 28 of a 32-entry cache (one real token in an 8-wide
    chunk) has its start clamped to 24, so the token lands at index 24 and
    the padded tail invalidates the entries of positions 25-27: the history
    at 24-27 is lost. In the engine (A decoding near ``max_len`` while B's
    8-wide prefill ticks run) the port's tokens equal the reference's,
    contiguous and paged."""
    jcfg, plan, jpl, cfg, tpl = _layer(models)
    x = _x((1, 28, cfg.d_model))
    _, jkv = jattn.mla_apply(jpl, jnp.asarray(x), jcfg, plan)
    _, tkv = attn.mla_apply(tpl, torch.from_numpy(x), cfg)
    jc = jattn.mla_seed_cache(jattn.mla_cache_init(
        jcfg, plan, 1, 32, jnp.float32), jkv, 28)
    tc = attn.mla_seed_cache(attn.mla_cache_init(cfg, 1, 32, torch.float32),
                             tkv, 28)
    xs = _x((1, 8, cfg.d_model), seed=5)
    jo, jc = jattn.mla_decode(jpl, jnp.asarray(xs), jc, 28, jcfg, plan,
                              n_valid=jnp.asarray([1]))
    to, tc = attn.mla_decode(tpl, torch.from_numpy(xs), tc, 28, cfg,
                             n_valid=np.array([1], np.int32))
    _close(to.numpy(), jo)
    _leaves(jc, tc)
    lost = list(range(24)) + [28] + [-1] * 7
    assert np.asarray(jc["pos_ids"])[0].tolist() == lost
    assert tc["pos_ids"][0].tolist() == lost
    _, jm, jp, model = models
    kw = dict(batch_slots=2, max_len=32, prefill_chunk=8, eos_id=-1,
              warmup=False)
    want = _clamp_run(JEngine(jm, jp, **kw), JRequest, model.cfg)
    for paged in (False, True):
        assert _clamp_run(Engine(model, paged=paged, **kw), Request,
                          model.cfg) == want, paged


def test_speculate_where_capacity_binds_follows_the_reference(models):
    """A reference fault, not intended behaviour: a verify chunk's rows
    share the dispatch group's expert capacity, so where the chunk's
    routes overflow an expert (four slots of repeating prompts, whose
    drafts route alike) the reference's ``speculate=3`` departs from its
    own greedy streams (ROADMAP queue 3). The port's greedy tokens equal
    the reference's greedy ones and its speculative tokens the
    reference's speculative ones."""
    _, jm, jp, model = models
    rng = np.random.default_rng(0)
    prompts = [np.resize(rng.integers(0, 256, 5 + 2 * i), n).astype(np.int32)
               for i, n in enumerate((37, 100, 60, 80))]
    kw = dict(batch_slots=4, max_len=160, eos_id=-1, warmup=False)

    def run(engine, request_cls):
        for rid, p in enumerate(prompts):
            engine.submit(request_cls(rid, p, max_new=24))
        engine.run()
        return {r.rid: tuple(r.out) for r in engine.finished}

    for paged in (False, True):
        jg = run(JEngine(jm, jp, paged=paged, **kw), JRequest)
        js = run(JEngine(jm, jp, paged=paged, speculate=3, **kw), JRequest)
        assert js != jg, paged  # the fault shows in the reference
        assert run(Engine(model, paged=paged, **kw), Request) == jg, paged
        assert run(Engine(model, paged=paged, speculate=3, **kw),
                   Request) == js, paged


def test_bf16_speculate_serves_greedy_where_nothing_is_dropped():
    """In bfloat16, at a capacity that drops no route, ``speculate=3``
    serves the greedy streams, contiguous and paged: each verify row takes
    its decode row's arithmetic (``L.by_column``: MLA and the MoE layer
    run a column at a time, the group's routes kept)."""
    cfg = registry.get(ARCH).reduced()
    cfg = cfg.replace(dtype="bfloat16", param_dtype="float32",
                      moe_capacity_factor=cfg.num_experts
                      / cfg.num_experts_per_tok * (1 + 1e-6))
    model = Model(cfg, device="cpu").init(0)
    rng = np.random.default_rng(2)
    prompts = [np.resize(rng.integers(0, 256, 5 + 2 * i), n).astype(np.int32)
               for i, n in enumerate((37, 60))]
    kw = dict(batch_slots=4, max_len=128, eos_id=-1, warmup=False)

    def run(engine):
        for rid, p in enumerate(prompts):
            engine.submit(Request(rid, p, max_new=24))
        engine.run()
        return {r.rid: tuple(r.out) for r in engine.finished}

    for paged in (False, True):
        eng = Engine(model, paged=paged, speculate=3, **kw)
        assert run(eng) == run(Engine(model, paged=paged, **kw)), paged
        assert eng.spec_accepted > 0
