"""The port's multimodal families (``repro_torch.models.multimodal``) against
the JAX package on ``llama-3.2-vision-11b.reduced()`` (one group of 2 self
blocks and a gated cross block over 16 image tokens) and
``whisper-small.reduced()`` (2 encoder and 2 decoder blocks over 32
frames), the reference's parameters carried across, inputs drawn with
numpy from a seed.

In float32 ``apply``, ``prefill`` (right-padded, ``lengths``) and the
decode steps agree with the JAX package within 1e-5, and decode equals the
forward within 2e-4 as ``tests/test_models.py`` holds the reference. The
cross and non-causal attention go to the flash kernel (its plain version
on the CPU) with ``causal=False``, S != T: that plain version equals
``_sdpa`` within 1e-5, and each prefill and decode step calls it where the
head dim fits. The engine refuses both families (it feeds its model
tokens only, as the reference's does); ``serve/step``'s prefill and decode
steps over a batch dict serve the reference's greedy tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models.model import Model as JModel
from repro.serve import step as jstep
from repro_torch.configs import registry
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import attention as attn
from repro_torch.models import params as pm
from repro_torch.models.model import Model
from repro_torch.serve import Engine, make_decode_step, make_prefill_step

ARCHS = ["llama-3.2-vision-11b", "whisper-small"]
TOL = 1e-5
B, S, P = 2, 24, 16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small ops: with several test processes sharing the cores, torch
    runs these on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(JAX model, its params, the port's model, a batch), float32."""
    kw = dict(dtype="float32", param_dtype="float32")
    jcfg = jregistry.get(request.param).reduced().replace(**kw)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = registry.get(request.param).reduced().replace(**kw)
    model = Model(cfg, device="cpu").load_reference(jax.device_get(jp))
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}
    key, n = (("image_embeds", cfg.num_image_tokens) if cfg.family == "vlm"
              else ("audio_frames", cfg.encoder_frames))
    batch[key] = (0.1 * rng.standard_normal((B, n, cfg.d_model))).astype(
        np.float32)
    return jm, jp, model, batch


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _prefix(batch, n):
    return dict(batch, tokens=batch["tokens"][:, :n])


@pytest.fixture
def flash_calls(monkeypatch):
    """Count the model's calls of the flash kernel's wrapper, by causal."""
    calls = []

    def counted(q, k, v, *, causal=True):
        calls.append((causal, q.shape[1], k.shape[1]))
        return FA.flash_attention_ref(q, k, v, causal=causal)

    monkeypatch.setitem(attn.KERNELS, "flash", counted)
    return calls


def test_param_tree_and_cache_are_the_references(pair):
    jm, jp, model, _ = pair
    want = jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                  jax.device_get(jp))
    got = pm.tree_map(lambda t: tuple(t.shape), model.weights())
    assert got == pm.tree_map(lambda s: s, want)
    assert model.n_params() == sum(
        int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(jp))
    jc = jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                jm.cache(3, 16, abstract=True))
    tc = pm.tree_map(lambda t: tuple(t.shape), model.cache(3, 16))
    assert tc == pm.tree_map(lambda s: s, jc)


def test_apply_prefill_decode_equal_reference(pair, flash_calls):
    """Every value within 1e-5: the forward, a right-padded prefill (rows of
    16 and 11 tokens) and its seeded cache (the cross K/V included), a
    ragged extend and a decode step; the flash kernel's plain version takes
    every cross and non-causal attention (``causal=False``, S != T) and the
    causal self-attention of the forward."""
    jm, jp, model, batch = pair
    cfg = model.cfg
    jl, _ = jm.apply(jp, batch)
    tl, aux = model.apply(batch)
    _close(tl.numpy(), jl)
    assert float(aux["moe_aux"]) == 0.0
    enc = cfg.encoder_layers
    n_cross = (cfg.num_layers // cfg.cross_attn_every if cfg.family == "vlm"
               else cfg.num_layers)
    n_self = cfg.num_layers
    assert sum(c for c, _, _ in flash_calls) == n_self
    assert sum(not c for c, _, _ in flash_calls) == n_cross + enc
    lengths = np.array([P, P - 5], np.int32)
    jl, jc = jm.prefill(jp, _prefix(batch, P), max_len=S,
                        lengths=jnp.asarray(lengths))
    tl, tc = model.prefill(_prefix(batch, P), max_len=S, lengths=lengths)
    _close(tl.numpy(), jl)
    for key in ("k", "v"):
        _close(tc["cross"][key].numpy(), jc["cross"][key])
        _close(tc["self"][key].numpy(), jc["self"][key])
    np.testing.assert_array_equal(tc["self"]["pos_ids"].numpy(),
                                  np.asarray(jc["self"]["pos_ids"]))
    toks = batch["tokens"]
    flash_calls.clear()
    steps = [(toks[:, P:P + 4], lengths, np.array([4, 2], np.int32)),
             (toks[:, P + 4:P + 5], lengths + np.array([4, 2]), None)]
    for chunk, pos, nv in steps:
        jl, jc = jm.decode(jp, jnp.asarray(chunk), jc, jnp.asarray(pos),
                           n_valid=None if nv is None else jnp.asarray(nv))
        tl, tc = model.decode(chunk, tc, pos, n_valid=nv)
        _close(tl.numpy(), jl)
    # the decode's cross steps, over the frozen cross K/V
    assert flash_calls == [(False, s, tc["cross"]["k"].shape[2])
                           for s in (4, 1) for _ in range(n_cross)]
    np.testing.assert_array_equal(tc["self"]["pos_ids"].numpy(),
                                  np.asarray(jc["self"]["pos_ids"]))


def test_decode_matches_forward(pair):
    """``tests/test_models.py``'s check for the reference: prefill of 16,
    then 8 one-token steps, each step's logits within 2e-4 of the
    forward's."""
    _, _, model, batch = pair
    full, _ = model.apply(batch)
    logits, cache = model.prefill(_prefix(batch, P), max_len=S)
    _close(logits[:, -1].numpy(), full[:, P - 1].numpy(), 2e-4)
    for t in range(P, S):
        logits, cache = model.decode(batch["tokens"][:, t:t + 1], cache, t)
        _close(logits[:, 0].numpy(), full[:, t].numpy(), 2e-4)


def test_serve_steps_give_the_reference_tokens(pair):
    """A prefill step over the batch dict, then 6 greedy decode steps
    through ``serve/step`` on both packages: the same tokens."""
    jm, jp, model, batch = pair
    pf = _prefix(batch, P)
    jl, jc = jstep.make_prefill_step(jm, S)(jp, pf)
    tl, tc = make_prefill_step(model, S)(pf)
    jdec, tdec = jstep.make_decode_step(jm), make_decode_step(model)
    want, got = [], []
    for t in range(P, P + 6):
        want.append(np.asarray(jnp.argmax(jl, -1)))
        got.append(torch.argmax(tl, -1).numpy())
        jl, jc = jdec(jp, jc, jnp.asarray(want[-1])[:, None], t)
        tl, tc = tdec(tc, torch.as_tensor(got[-1])[:, None], t)
    np.testing.assert_array_equal(np.stack(got), np.stack(want))


@pytest.mark.parametrize("S_,T,H,Hkv,D", [(1, 37, 4, 2, 16),
                                         (5, 32, 4, 4, 64),
                                         (16, 16, 2, 1, 32),
                                         (7, 70, 8, 2, 128)])
def test_flash_plain_non_causal_equals_sdpa(S_, T, H, Hkv, D):
    rng = np.random.default_rng(S_ + T)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, S_, H, D), (2, T, Hkv, D), (2, T, Hkv, D)))
    got = FA.flash_attention_ref(q, k, v, causal=False)
    torch.testing.assert_close(got, attn._sdpa(q, k, v, None), rtol=TOL,
                               atol=TOL)


def test_engine_refuses_the_multimodal_families():
    for arch in ARCHS:
        model = Model(registry.get(arch).reduced(), device="cpu")
        with pytest.raises(ValueError, match="serve/step"):
            Engine(model, warmup=False)
