"""The port's MoE layer (``repro_torch.models.moe``) and the moe family's
stack against the JAX package on ``mixtral-8x7b.reduced()`` (8 experts
top-2 of 64, d_model 64) in float32, the same numpy inputs and the
reference's parameters on both sides.

Discrete outputs are held equal: the router's top-2 experts (the lower
index first on a tie, ``jax.lax.top_k``'s order; a route that differs
must be a near-tie, the 2nd and 3rd probabilities within 1e-6, and is
printed) and which routes the capacity keeps and drops. Values agree
within 1e-5 (the router) and 1e-4 (the layer's output and the model's
logits), at capacity factor 1.25, where routes are dropped (asserted),
and 16, where none are; with several dispatch groups
(``moe_group_size=8``), a shared expert and a leading dense block
(``first_k_dense=1``). The reference's own MoE checks
(``tests/test_models.py``: decode equals the forward, the router's
weights sum to 1 and its balance loss is at least 1, a no-drop layer is
permutation invariant) hold for the port too, and a paged engine over the
stack with its dense block serves the contiguous engine's tokens. A
speculative verify's chunk run a column at a time keeps the whole chunk's
routes, and its rows equal their decode ticks' rows where the routes are
kept alike.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import moe as jmoe
from repro.models import params as jpm
from repro.models.model import Model as JModel
from repro.sharding.plan import make_plan
from repro_torch.configs import registry
from repro_torch.models import moe
from repro_torch.models import params as pm
from repro_torch.models.model import Model
from repro_torch.serve import Engine, Request

ARCH = "mixtral-8x7b"
NEAR_TIE = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small ops: with several test processes sharing the cores, torch
    runs these on one thread (no op here is large enough for its result to
    depend on the count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    kw = dict(dtype="float32", param_dtype="float32", **kw)
    return (jregistry.get(ARCH).reduced().replace(**kw),
            registry.get(ARCH).reduced().replace(**kw))


def _layer_params(jcfg, seed=0):
    """The reference's MoE layer parameters: (jax tree, torch tree)."""
    jp = jpm.materialize(jmoe.moe_params(jcfg, make_plan(jcfg)),
                         jax.random.PRNGKey(seed), "float32")
    return jp, pm.from_reference(jax.device_get(jp))


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _same_routes(want, got, probs):
    """The port's expert choices equal the reference's, or differ only
    where the k-th and (k + 1)-th probabilities are a near-tie."""
    want, got = np.asarray(want), np.asarray(got)
    k = want.shape[-1]
    srt = -np.sort(-np.asarray(probs), axis=-1)
    bad = np.nonzero((want != got).any(-1))
    for i in zip(*bad):
        margin = float(srt[i][k - 1] - srt[i][k])
        print(f"route {i} differs: {want[i]} vs {got[i]}, margin {margin:.3e}")
        assert margin < NEAR_TIE, f"route {i} differs at margin {margin}"


def _keep(idx, E, cap):
    """The capacity's kept routes of (n, T, k) choices, flattened
    token-major then by rank, as the reference's dispatch takes them."""
    flat = np.asarray(idx).reshape(idx.shape[0], -1)
    onehot = np.eye(E, dtype=np.int64)[flat]
    pos = (np.cumsum(onehot, 1) - onehot)[
        np.arange(flat.shape[0])[:, None], np.arange(flat.shape[1]), flat]
    return pos < cap


@pytest.mark.parametrize("shape", [(32, 8), (2, 16, 8), (3, 7, 8)])
def test_router_topk_equals_reference(shape):
    logits = _x(shape, seed=sum(shape))
    logits[0, ..., 3] = logits[0, ..., 5]  # an exact tie on some row
    w, idx, aux, z = jmoe.router_topk(jnp.asarray(logits), 2)
    tw, tidx, taux, tz = moe.router_topk(torch.from_numpy(logits), 2)
    probs = jax.nn.softmax(jnp.asarray(logits), -1)
    _same_routes(idx, tidx.numpy(), probs)
    np.testing.assert_allclose(tw.numpy(), np.asarray(w), atol=1e-5)
    np.testing.assert_allclose(float(taux), float(aux), atol=1e-5)
    np.testing.assert_allclose(float(tz), float(z), rtol=1e-5, atol=1e-5)
    # the reference's own invariants
    np.testing.assert_allclose(tw.sum(-1).numpy(), 1.0, atol=1e-5)
    assert float(taux) >= 1.0 - 1e-5


def test_ties_take_the_lower_index_first():
    probs_logits = torch.zeros((1, 8))
    probs_logits[0, [2, 6]] = 1.0
    _, idx, _, _ = moe.router_topk(probs_logits, 2)
    assert idx.tolist() == [[2, 6]]
    _, idx, _, _ = moe.router_topk(torch.zeros((1, 8)), 2)
    assert idx.tolist() == [[0, 1]]


@pytest.mark.parametrize("cf,drops", [(1.25, True), (16.0, False)])
def test_dispatch_equals_reference(cf, drops):
    jcfg, cfg = _cfgs(moe_capacity_factor=cf)
    jp, tp = _layer_params(jcfg)
    x = _x((2, 24, cfg.d_model))
    cap = moe.capacity(cfg, 24)
    out, aux, z = jmoe._dispatch_batched(jp, jnp.asarray(x), jcfg,
                                         make_plan(jcfg), cap)
    with moe.capture_routes() as routes:
        tout, taux, tz = moe._dispatch_batched(tp, torch.from_numpy(x), cfg,
                                               cap)
    routes, = routes
    logits = jnp.einsum("ntd,de->nte", jnp.asarray(x), jp["router"])
    _, idx, _, _ = jmoe.router_topk(logits, 2)
    _same_routes(idx, routes["idx"].numpy(), jax.nn.softmax(logits, -1))
    keep = _keep(np.asarray(idx), cfg.num_experts, cap)
    np.testing.assert_array_equal(routes["keep"].numpy(), keep)
    assert bool((~keep).any()) == drops
    np.testing.assert_allclose(tout.numpy(), np.asarray(out), atol=1e-4)
    np.testing.assert_allclose(float(taux), float(aux), atol=1e-5)
    np.testing.assert_allclose(float(tz), float(z), rtol=1e-5)
    margin = moe.route_margin(routes["logits"], 2)
    assert margin.shape == (2, 24) and (margin >= 0).all()


@pytest.mark.parametrize("cf,group,shared", [
    (1.25, 8, 0), (1.25, 0, 1), (16.0, 8, 1), (1.25, 16, 1)])
def test_moe_apply_equals_reference(cf, group, shared):
    """Several dispatch groups (``moe_group_size``), each with its own
    capacity, and a shared expert added."""
    jcfg, cfg = _cfgs(moe_capacity_factor=cf, moe_group_size=group,
                      num_shared_experts=shared)
    jp, tp = _layer_params(jcfg, seed=3)
    # tokens that share a component favour the same experts: crowded
    x = _x((2, 16, cfg.d_model), seed=4) + 2 * _x((1, 1, cfg.d_model), 9)
    out, losses = jmoe.moe_apply(jp, jnp.asarray(x), jcfg, make_plan(jcfg))
    with moe.capture_routes() as routes:
        tout, tl = moe.moe_apply(tp, torch.from_numpy(x), cfg)
    assert len(routes) == 32 // (group or 32)
    gs = group or 32
    cap = moe.capacity(cfg, gs)
    for g, r in enumerate(routes):
        xg = x.reshape(-1, gs, cfg.d_model)[g][None]
        logits = jnp.einsum("ntd,de->nte", jnp.asarray(xg), jp["router"])
        _, idx, _, _ = jmoe.router_topk(logits, 2)
        _same_routes(idx, r["idx"].numpy(), jax.nn.softmax(logits, -1))
        np.testing.assert_array_equal(
            r["keep"].numpy(), _keep(np.asarray(idx), cfg.num_experts, cap))
    dropped = sum(int((~r["keep"]).sum()) for r in routes)
    assert (dropped > 0) == (cf < 2)
    np.testing.assert_allclose(tout.numpy(), np.asarray(out), atol=1e-4)
    for key in ("moe_aux", "moe_z"):
        np.testing.assert_allclose(float(tl[key]), float(losses[key]),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [1.25, 16.0])
def test_verify_chunk_by_column(cf, dtype):
    """A speculative verify's chunk (``cols``, 4 slots x 4 rows): the
    group's routes and the capacity's kept routes are the whole chunk's
    (the reference's), and in float32 the output is within 1e-5 of it.
    Each row whose routes the group keeps as a decode tick of its column
    keeps them equals that tick's row bit for bit, in both dtypes: at
    capacity factor 1.25, where the group drops routes (asserted), and at
    16, where every row is such a row."""
    _, cfg = _cfgs(moe_capacity_factor=cf, num_shared_experts=1)
    cfg = cfg.replace(dtype=dtype)
    dt = getattr(torch, dtype)
    tp = pm.tree_map(lambda t: t.to(dt), pm.materialize(
        moe.moe_params(cfg), torch.Generator().manual_seed(5), "float32"))
    B, S, k = 4, 4, cfg.num_experts_per_tok
    x = torch.from_numpy(_x((B, S, cfg.d_model), seed=6)
                         + 2 * _x((1, 1, cfg.d_model), 9)).to(dt)
    with moe.capture_routes() as whole_r:
        whole, _ = moe.moe_apply(tp, x, cfg)
    with moe.capture_routes() as col_r:
        by_col, _ = moe.moe_apply(tp, x, cfg, cols=True)
    (w,), (c,) = whole_r, col_r
    if dtype == "float32":
        assert torch.equal(w["idx"], c["idx"])
        assert torch.equal(w["keep"], c["keep"])
        np.testing.assert_allclose(by_col.numpy(), whole.numpy(),
                                   rtol=1e-5, atol=1e-5)
    keep = c["keep"].reshape(B, S, k)
    assert bool((~keep).any()) == (cf < 2)
    same = 0
    for j in range(S):
        with moe.capture_routes() as tick_r:
            tick, _ = moe.moe_apply(tp, x[:, j:j + 1].contiguous(), cfg)
        assert torch.equal(tick_r[0]["idx"][0], c["idx"][0, j::S])
        rows = (tick_r[0]["keep"].reshape(B, k) == keep[:, j]).all(-1)
        for b in torch.nonzero(rows)[:, 0].tolist():
            assert torch.equal(by_col[b, j], tick[b, 0]), (b, j)
            same += 1
    assert same == B * S if cf > 2 else 0 < same < B * S


def test_group_that_does_not_divide_raises():
    _, cfg = _cfgs(moe_group_size=8)
    tp = pm.materialize(moe.moe_params(cfg), torch.Generator().manual_seed(0),
                        "float32")
    with pytest.raises(ValueError, match="dispatch groups"):
        moe.moe_apply(tp, torch.zeros((1, 12, cfg.d_model)), cfg)


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_no_drop_moe_is_permutation_invariant(seed):
    """tests/test_models.py's invariant: with ample capacity the layer is
    per-token, so permuting the tokens permutes the output."""
    _, cfg = _cfgs(moe_capacity_factor=16.0)
    g = torch.Generator().manual_seed(seed)
    tp = pm.materialize(moe.moe_params(cfg), g, "float32")
    x = torch.randn((1, 16, cfg.d_model), generator=g)
    perm = torch.randperm(16, generator=g)
    out, _ = moe.moe_apply(tp, x, cfg)
    out_p, _ = moe.moe_apply(tp, x[:, perm], cfg)
    torch.testing.assert_close(out[:, perm], out_p, atol=1e-4, rtol=0)


@pytest.fixture(scope="module")
def models():
    """A 3-layer mixtral with a leading dense block, a shared expert and
    dispatch groups of 8, at capacity factor 1.25: (JAX model, its params,
    the port's model on the CPU)."""
    jcfg, cfg = _cfgs(num_layers=3, first_k_dense=1, num_shared_experts=1,
                      moe_group_size=8)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(5))
    return jm, jp, Model(cfg, device="cpu").load_reference(
        jax.device_get(jp))


def test_param_tree_is_the_references(models):
    jm, jp, model = models
    want = jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                  jax.device_get(jp))
    got = pm.tree_map(lambda t: tuple(t.shape), model.weights())
    assert got == pm.tree_map(lambda s: s, want)
    assert set(got["blocks"]) == {"stack", "dense0"}
    assert "moe" in got["blocks"]["stack"] and "mlp" in got["blocks"]["dense0"]
    assert model.n_params() == sum(
        int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(jp))


def test_apply_equals_reference(models):
    jm, jp, model = models
    toks = np.random.default_rng(6).integers(0, 256, (2, 16)).astype(np.int32)
    logits, aux = jm.apply(jp, {"tokens": jnp.asarray(toks)})
    tl, taux = model.apply({"tokens": toks})
    np.testing.assert_allclose(tl.numpy(), np.asarray(logits), atol=1e-4)
    for key in ("moe_aux", "moe_z"):
        np.testing.assert_allclose(float(taux[key]), float(aux[key]),
                                   rtol=1e-5)
    assert float(taux["moe_aux"]) > 0


def test_prefill_and_decode_equal_reference(models):
    """Prefill of 8, then a ragged extend (rows of 8 and 5 real tokens)
    and two one-token steps, on both packages: logits within 1e-4 at
    every step, every cache leaf, the dense block's included, within 1e-4
    and its position table equal."""
    jm, jp, model = models
    toks = np.random.default_rng(8).integers(0, 256, (2, 18)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :8])}, max_len=24)
    tl, tc = model.prefill({"tokens": toks[:, :8]}, max_len=24)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    assert set(tc) == {"stack", "dense0"}
    steps = [(toks[:, 8:16], 8, np.array([8, 5], np.int32)),
             (toks[:, 16:17], np.array([16, 13], np.int32), None),
             (toks[:, 17:18], np.array([17, 14], np.int32), None)]
    jdecode = jax.jit(lambda p, tok, c, pos, nv=None: jm.decode(
        p, tok, c, pos, n_valid=nv))
    for chunk, pos, nv in steps:
        jl, jc = jdecode(jp, jnp.asarray(chunk), jc, jnp.asarray(pos),
                         None if nv is None else jnp.asarray(nv))
        tl, tc = model.decode(chunk, tc, pos, n_valid=nv)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    for path in (("dense0",), ("stack",)):
        jt, tt = jc, tc
        for key in path:
            jt, tt = jt[key], tt[key]
        np.testing.assert_array_equal(tt["pos_ids"].numpy(),
                                      np.asarray(jt["pos_ids"]))
        np.testing.assert_allclose(tt["k"].numpy(), np.asarray(jt["k"]),
                                   atol=1e-4)


def test_decode_matches_forward():
    """tests/test_models.py's decode == forward for mixtral (ample
    capacity, so the forward's one dispatch group and the steps' agree)."""
    jcfg, cfg = _cfgs(moe_capacity_factor=16.0)
    jp = JModel(jcfg).init(jax.random.PRNGKey(0))
    model = Model(cfg, device="cpu").load_reference(jax.device_get(jp))
    toks = np.random.default_rng(1).integers(0, 256, (2, 24)).astype(np.int32)
    full, _ = model.apply({"tokens": toks})
    logits, cache = model.prefill({"tokens": toks[:, :16]}, max_len=24)
    np.testing.assert_allclose(logits[:, -1].numpy(), full[:, 15].numpy(),
                               atol=2e-4)
    for t in range(16, 24):
        logits, cache = model.decode(toks[:, t:t + 1], cache, t)
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, t].numpy(),
                                   atol=2e-4, err_msg=f"step {t}")


def test_bf16_model_runs_the_experts_in_bf16():
    """The compute dtype reaches the experts: the router and the experts'
    weights are cast, the router's softmax stays float32."""
    cfg = registry.get(ARCH).reduced()
    model = Model(cfg, device="cpu").init(0)
    p = model.params["blocks"]["stack"]["moe"]
    assert p["router"].dtype == p["wg"].dtype == torch.bfloat16
    logits, aux = model.apply({"tokens": np.arange(16).reshape(2, 8)})
    assert logits.dtype == torch.bfloat16 and aux["moe_z"].dtype == \
        torch.float32
    assert torch.isfinite(logits.float()).all()


def test_paged_engine_with_a_dense_block_equals_contiguous(models):
    """The serve path over a stack with a leading dense block (its cache
    ``dense0`` beside the stacked layers' in the pool, the slot axis 0
    there and 1 in the stack): the paged engine serves the contiguous
    engine's tokens, a preemption and its resume included."""
    _, _, model = models
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (5, 30, 9)]
    outs = {}
    for paged in (False, True):
        eng = Engine(model, batch_slots=2, max_len=64, eos_id=-1,
                     warmup=False, paged=paged)
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid, p, max_new=10))
        ticks = 0
        while eng.step():
            ticks += 1
            if ticks == 4:
                assert eng.preempt_to(1) == 1
        assert eng.preempts == 1
        outs[paged] = {r.rid: tuple(r.out) for r in eng.finished}
    assert outs[True] == outs[False]
    assert set(eng.mgr.pool) == {"stack", "dense0"}
