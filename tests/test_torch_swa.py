"""The port's sliding-window ring cache (``repro_torch.models.attention``)
and the mixtral serve path against the JAX package, float32, on
``mixtral-8x7b.reduced()`` with the reference's parameters carried across.

- The ring scatter: entries wrap index-wise and a padded tail across the
  ring's edge overwrites nothing; ids and values exactly the reference's.
- Decode through the ring equals the full forward within 2e-4 (one-token
  steps, and chunks that cross the wrap, the ragged (3, 2) chunk included;
  ``tests/test_models.py``'s two ring tests) and the reference's logits
  within 1e-5 at every step.
- Windowed self-attention (``_sdpa`` under the window mask) equals the
  reference's ``blockwise_sdpa``, the form it takes at
  ``BLOCKWISE_THRESHOLD`` and beyond.
- The serve engine, contiguous (the ring form of ``_sdpa``) and paged (the
  paged kernel's plain version with the window bound; on a ring as long as
  the window each chunk passes through the slot's scratch pages), serves
  the reference engine's tokens with its page counts, at window 32 with
  prompts that wrap the ring (mid-chunk too) and at the default window.

A fault of the reference is reproduced on purpose and pinned here, not
held as a contract: a prefill longer than the ring keeps its last T
entries from ring index 0 (``repro/models/attention.py:319-323``) while
decode writes position p at ``p % T``, so the first decode step overwrites
a live entry and the steps after it attend the wrong keys (ROADMAP queue
3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import attention as jattn
from repro.models import params as jpm
from repro.models.model import Model as JModel
from repro.serve.engine import Engine as JEngine, Request as JRequest
from repro.sharding.plan import make_plan
from repro_torch.configs import registry
from repro_torch.models import attention as attn
from repro_torch.sharding import plan as tplan
from repro_torch.models import params as pm
from repro_torch.models.model import Model
from repro_torch.serve import Engine, Request

ARCH = "mixtral-8x7b"


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


def _pair(seed=0, **kw):
    """(JAX model, its params, the port's model on the CPU)."""
    jcfg, cfg = _cfgs(**kw)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    return jm, jp, Model(cfg, device="cpu").load_reference(
        jax.device_get(jp))


def _jit_decode(jm):
    """The reference's decode, compiled once per shape (pos traced)."""
    return jax.jit(lambda p, tok, c, pos, nv=None: jm.decode(
        p, tok, c, pos, n_valid=nv))


def _tokens(shape, seed=1):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.int32)


# --- the ring -----------------------------------------------------------------

def test_ring_scatter_equals_reference():
    """Rows at the ring's edge: one wraps its whole chunk, one's padded
    tail crosses the edge (and must leave the entries there alone), one
    writes nothing (n_valid 0)."""
    rng = np.random.default_rng(0)
    T, S = 8, 5
    arr = rng.standard_normal((4, T, 2, 3)).astype(np.float32)
    new = rng.standard_normal((4, S, 2, 3)).astype(np.float32)
    ids = rng.integers(0, 50, (4, T)).astype(np.int32)
    start = np.array([6, 7, 3, 0], np.int32)
    n_valid = np.array([5, 1, 2, 0], np.int32)
    pos = start[:, None] + np.arange(S, dtype=np.int32)[None]
    for nv in (n_valid, None):
        want = jattn._ring_scatter(jnp.asarray(arr), jnp.asarray(new),
                                   jnp.asarray(start), nv)
        got = attn._ring_scatter(torch.from_numpy(arr.copy()),
                                 torch.from_numpy(new), torch.from_numpy(start),
                                 None if nv is None else torch.from_numpy(nv))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        jids = jattn._new_pos_ids(jnp.asarray(pos), nv)
        tids = attn._new_pos_ids(torch.from_numpy(pos),
                                 None if nv is None else torch.from_numpy(nv))
        np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
        want = jattn._ring_scatter(jnp.asarray(ids), jids,
                                   jnp.asarray(start), nv)
        got = attn._ring_scatter(torch.from_numpy(ids.copy()), tids,
                                 torch.from_numpy(start),
                                 None if nv is None else torch.from_numpy(nv))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        if nv is not None:  # row 1's padded tail past the edge: untouched
            np.testing.assert_array_equal(got.numpy()[1, :3], ids[1, :3])
    with pytest.raises(ValueError, match="lap"):
        attn._ring_scatter(torch.zeros((1, 4)), torch.zeros((1, 5)),
                           torch.zeros(1, dtype=torch.int32), None)


@pytest.mark.parametrize("window,max_len", [(8, 16), (32, 16), (0, 16)])
def test_cache_extent_is_the_references(window, max_len):
    jcfg, cfg = _cfgs(sliding_window=window)
    want = jattn.gqa_cache_init(jcfg, make_plan(jcfg), 2, max_len,
                                jnp.float32)
    got = attn.gqa_cache_init(cfg, 2, max_len, torch.float32,
                              plan=tplan.make_plan(cfg))
    for key in want:
        assert tuple(got[key].shape) == want[key].shape
    assert attn.cache_len(cfg, max_len) == got["k"].shape[1]


def test_windowed_apply_equals_blockwise(monkeypatch):
    """The reference's windowed self-attention takes ``blockwise_sdpa``
    from ``BLOCKWISE_THRESHOLD`` tokens on; the port's ``_sdpa`` under the
    window mask gives the same (the threshold lowered for the run so that
    the reference takes that form at a small size)."""
    jcfg, cfg = _cfgs(sliding_window=64)
    plan = make_plan(jcfg)
    jp = jpm.materialize(jattn.gqa_params(jcfg, plan),
                         jax.random.PRNGKey(2), "float32")
    tp = pm.from_reference(jax.device_get(jp))
    x = np.random.default_rng(3).standard_normal((2, 256, cfg.d_model)) \
        .astype(np.float32)
    calls = []
    blockwise = jattn.blockwise_sdpa
    monkeypatch.setattr(jattn, "BLOCKWISE_THRESHOLD", 128)
    monkeypatch.setattr(jattn, "blockwise_sdpa", lambda *a, **k: (
        calls.append(k), blockwise(*a, **k, q_block=64, kv_block=32))[1])
    want, (wk, _) = jattn.gqa_apply(jp, jnp.asarray(x), jcfg, plan)
    assert calls == [{"causal": True, "window": 64}]
    got, (tk, _) = attn.gqa_apply(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(tk.numpy(), np.asarray(wk), atol=1e-5)


@pytest.fixture(scope="module")
def ring8():
    return _pair(sliding_window=8, moe_capacity_factor=16.0)


def test_ring_decode_matches_forward(ring8):
    """tests/test_models.py::test_sliding_window_ring_cache on the port,
    and the reference's logits at every step."""
    jm, jp, model = ring8
    jdecode = _jit_decode(jm)
    toks = _tokens((1, 24))
    full, _ = model.apply({"tokens": toks})
    logits, cache = model.prefill({"tokens": toks[:, :4]}, max_len=24)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :4])}, max_len=24)
    assert cache["stack"]["k"].shape[2] == 8  # (L, B, T=window, hkv, dh)
    for t in range(4, 24):
        logits, cache = model.decode(toks[:, t:t + 1], cache, t)
        jl, jc = jdecode(jp, jnp.asarray(toks[:, t:t + 1]), jc, t)
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, t].numpy(),
                                   atol=2e-4, err_msg=f"step {t}")
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=1e-5,
                                   err_msg=f"step {t}")
    np.testing.assert_array_equal(cache["stack"]["pos_ids"].numpy(),
                                  np.asarray(jc["stack"]["pos_ids"]))


def test_chunked_prefill_past_wrap(ring8):
    """tests/test_models.py::test_sliding_window_chunked_prefill_past_wrap
    on the port: chunks that straddle the wrap and a ragged (3, 2) chunk
    whose padded slot crosses the ring's edge, against the forward and
    the reference's logits."""
    jm, jp, model = ring8
    jdecode = _jit_decode(jm)
    toks = _tokens((1, 26))
    full, _ = model.apply({"tokens": toks})
    _, cache = model.prefill({"tokens": toks[:, :4]}, max_len=26)
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :4])}, max_len=26)
    t = 4
    for k, nv in [(3, 3), (3, 2), (4, 4), (4, 4), (4, 4), (4, 4), (1, 1)]:
        chunk = toks[:, t:t + k]
        if chunk.shape[1] < k:
            chunk = np.pad(chunk, ((0, 0), (0, k - chunk.shape[1])))
        n_valid = None if nv == k else np.asarray([nv], np.int32)
        logits, cache = model.decode(chunk, cache, t, n_valid=n_valid)
        jl, jc = jdecode(jp, jnp.asarray(chunk), jc, t,
                         None if n_valid is None else jnp.asarray(n_valid))
        np.testing.assert_allclose(logits[:, :nv].numpy(),
                                   full[:, t:t + nv].numpy(), atol=2e-4,
                                   err_msg=f"chunk at {t} (+{nv})")
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=1e-5,
                                   err_msg=f"chunk at {t} (+{nv})")
        t += nv
    assert t == 26
    np.testing.assert_array_equal(cache["stack"]["pos_ids"].numpy(),
                                  np.asarray(jc["stack"]["pos_ids"]))


def test_pin_reference_fault_seed_cache_ring_offset(ring8):
    """Pins a fault of the reference, reproduced on purpose: a 12-token
    prefill into an 8-entry ring stores positions 4..11 at ring indices
    0..7, but decode writes position p at p % 8, so step 1 (position 12)
    overwrites position 8, still in the window of every later step. Both
    packages give the same logits at every step, and both leave the full
    forward by more than 0.1 from step 2 on."""
    jm, jp, model = ring8
    jdecode = _jit_decode(jm)
    toks = _tokens((1, 16), seed=4)
    full, _ = model.apply({"tokens": toks})
    _, cache = model.prefill({"tokens": toks[:, :12]}, max_len=16)
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :12])}, max_len=16)
    np.testing.assert_array_equal(cache["stack"]["pos_ids"][0, 0].numpy(),
                                  np.arange(4, 12))
    for step, t in enumerate(range(12, 16), start=1):
        logits, cache = model.decode(toks[:, t:t + 1], cache, t)
        jl, jc = jdecode(jp, jnp.asarray(toks[:, t:t + 1]), jc, t)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=2e-4,
                                   err_msg=f"step {step}")
        off = float((logits[:, 0] - full[:, t]).abs().max())
        joff = float(np.abs(np.asarray(jl)[:, 0] - full[:, t].numpy()).max())
        if step == 1:
            assert off < 2e-4 and joff < 2e-4
        else:
            assert off > 0.1 and joff > 0.1, (step, off, joff)


# --- the serve path -------------------------------------------------------------

SWA_PROMPTS = (5, 40, 50, 9)  # 40 and 50 wrap a 32-entry ring
SWA_KW = dict(batch_slots=2, max_len=64, eos_id=-1, warmup=False,
              prefill_chunk=12)  # chunks of 12 cross the wrap mid-chunk


def _swa_prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(0, 256, n).astype(np.int32) for n in SWA_PROMPTS]


def _run(engine_cls, request_cls, model, *args, **kw):
    eng = engine_cls(model, *args, **kw, **SWA_KW)
    for rid, p in enumerate(_swa_prompts()):
        eng.submit(request_cls(rid, p, max_new=12))
    ticks = 0
    pages = []
    while eng.step():
        ticks += 1
        pages.append(eng.mgr.pages_in_use)
    return ({r.rid: tuple(r.out) for r in eng.finished},
            (pages, eng.mgr.peak_pages, eng.mgr.pages_in_use), eng)


@pytest.fixture(scope="module", params=[32, None], ids=["window32",
                                                         "default"])
def swa_runs(request):
    """The reference engine's runs, contiguous and paged, and the port's
    model, at window 32 (the ring wraps) and at the default window (4096:
    the ring is max_len long and never wraps)."""
    kw = {} if request.param is None else {"sliding_window": request.param}
    jm, jp, model = _pair(seed=1, **kw)
    ref = {paged: _run(JEngine, JRequest, jm, jp, paged=paged)[:2]
           for paged in (False, True)}
    return request.param, model, ref


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_swa_engine_equals_reference(swa_runs, paged):
    window, model, ref = swa_runs
    toks, pages, eng = _run(Engine, Request, model, paged=paged)
    want_toks, want_pages = ref[paged]
    assert toks == want_toks
    assert toks == ref[False][0]  # paged == contiguous == the reference
    assert pages == want_pages
    if paged:
        ring = attn.cache_len(model.cfg, SWA_KW["max_len"])
        assert eng.mgr.seq_len == ring == (window or SWA_KW["max_len"])
        scratch = eng.mgr.scratch_table
        if window:  # one 16-entry scratch page per slot for chunks of 12
            assert scratch.shape == (2, 1)
            assert (scratch > eng.mgr.null_page).all()
        else:
            assert scratch is None
        assert eng.mgr.recount_pages() == 0


def test_paged_ring_chunk_needs_scratch_pages():
    """A chunk on a ring as long as the window without scratch pages
    would evict entries its own earlier tokens see: refused."""
    cfg = registry.get(ARCH).reduced().replace(dtype="float32",
                                               sliding_window=32)
    model = Model(cfg, device="cpu").init(0)
    pool = model.cache(5, 16)
    bt = torch.tensor([[0, 1]], dtype=torch.int32)
    with pytest.raises(ValueError, match="scratch pages"):
        model.decode(np.zeros((1, 4), np.int32), pool, 0, block_table=bt)
    logits, _ = model.decode(np.zeros((1, 4), np.int32), pool, 0,
                             block_table=bt,
                             scratch_table=torch.tensor([[4]],
                                                        dtype=torch.int32))
    assert torch.isfinite(logits).all()
