"""The port's models (``repro_torch.models``) against the JAX package, with
the reference's parameters carried across by ``Model.load_reference``
(``params.from_reference``): the dense family on ``llama3.2-1b.reduced()``,
and the recurrent families on ``mamba2-780m.reduced()`` (ssm),
``zamba2-1.2b.reduced()`` (hybrid: 2 groups of 2 mamba layers, no tail) and a
5-layer zamba2 (2 groups and a tail of 1).

``apply``, ``prefill`` and ragged ``decode`` agree within 1e-5 in float32,
also for qwen3-1.7b (qk_norm, tied embeddings), nemotron-4-15b (relu2) and
deepseek-67b, reduced;
in bfloat16 (the working type) within atol 0.06 with top-1 agreement above
0.95, the reference's bound between its own bf16 tiers
(``tests/test_tolerance.py``, scan vs loop). The recurrent families are held
in float32 (the reference's own bf16 mamba2 tiers do not hold that bound to
each other, ROADMAP queue 3), logits and every cache leaf within 5e-4: two
correct float32 orders of the scan's sums differ by up to 2e-4 in one scan
(the reference's bound between its scan kernel and oracle), and over the
layers they reach 1.5e-4 on logits of magnitude ~4 (measured: the port with
the reference-form ``ssd_chunked`` in place of the kernel's plain version
lands as far from the reference). On the CPU the model's causal
attention runs the flash kernel's plain version, the paged decode the paged
kernel's and the SSD scan the scan kernel's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models.model import Model as JModel
from repro_torch.configs import registry
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import paged_attention as PA
from repro_torch.models import attention as attn
from repro_torch.models import params as pm
from repro_torch.models.model import Model
from repro_torch.sharding.plan import make_plan

ARCH = "llama3.2-1b"
BF16_ATOL, TOP1 = 0.06, 0.95


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    """(dtype, JAX model, its params, the port's model on the CPU)."""
    dt = request.param
    jcfg = jregistry.get(ARCH).reduced().replace(dtype=dt)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = registry.get(ARCH).reduced().replace(dtype=dt)
    model = Model(cfg, device="cpu").load_reference(jax.device_get(jp))
    return dt, jm, jp, model


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.int32)


def _close(dt, got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    if dt == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        return
    assert np.abs(got - want).max() <= BF16_ATOL
    agree = (got.argmax(-1) == want.argmax(-1)).mean()
    assert agree > TOP1, agree


def test_apply(pair):
    dt, jm, jp, model = pair
    toks = _tokens((4, 32))
    jl, jaux = jm.apply(jp, {"tokens": toks})
    before = FA.flash_attention.launches
    tl, aux = model.apply({"tokens": toks})
    assert FA.flash_attention.launches == before  # plain version on the CPU
    assert tl.dtype == getattr(torch, dt) and tl.shape == jl.shape
    assert set(aux) == set(jaux)
    _close(dt, tl, jl)


def test_prefill_seeds_the_cache(pair):
    dt, jm, jp, model = pair
    toks = _tokens((4, 32), seed=1)
    lengths = np.array([32, 20, 32, 7], np.int32)
    jl, jc = jm.prefill(jp, {"tokens": toks}, max_len=48, lengths=lengths)
    tl, tc = model.prefill({"tokens": toks}, max_len=48, lengths=lengths)
    _close(dt, tl, jl)
    js, ts = jc["stack"], tc["stack"]
    np.testing.assert_array_equal(ts["pos_ids"].numpy(),
                                  np.asarray(js["pos_ids"]))
    for name in ("k", "v"):
        assert tuple(ts[name].shape) == js[name].shape
        tol = 1e-5 if dt == "float32" else BF16_ATOL
        np.testing.assert_allclose(ts[name].float().numpy(),
                                   np.asarray(js[name], np.float32),
                                   rtol=tol, atol=tol)


def _decode_pair(jm, jp, model, toks, pos, n_valid, max_len):
    """Prefill a 6-token prompt into a max_len cache on both sides, then one
    ragged decode step."""
    prompt = _tokens((toks.shape[0], 6), seed=2)
    _, jc = jm.prefill(jp, {"tokens": prompt}, max_len=max_len)
    _, tc = model.prefill({"tokens": prompt}, max_len=max_len)
    jl, jc = jm.decode(jp, toks, jc, jnp.asarray(pos),
                       n_valid=jnp.asarray(n_valid))
    tl, tc = model.decode(toks, tc, torch.as_tensor(pos),
                          n_valid=torch.as_tensor(n_valid))
    return jl, jc, tl, tc


def test_ragged_decode(pair):
    """Rows at their own positions: a full 16-token extend, a decode token,
    a disabled row (n_valid = 0) and a 9-token extend."""
    dt, jm, jp, model = pair
    toks = _tokens((4, 16), seed=3)
    pos = np.array([6, 4, 0, 2], np.int32)
    n_valid = np.array([16, 1, 0, 9], np.int32)
    jl, jc, tl, tc = _decode_pair(jm, jp, model, toks, pos, n_valid, 32)
    _close(dt, tl, jl)
    np.testing.assert_array_equal(tc["stack"]["pos_ids"].numpy(),
                                  np.asarray(jc["stack"]["pos_ids"]))


def test_decode_clamps_a_chunk_at_the_row_end(pair):
    """A width-8 chunk at pos 14 of a 16-entry row: the write start clamps
    to 8 as the reference's ``dynamic_update_slice`` does, and the padded
    tail overwrites history (ROADMAP queue 3)."""
    dt, jm, jp, model = pair
    toks = _tokens((4, 8), seed=4)
    pos = np.array([14, 3, 6, 0], np.int32)
    n_valid = np.array([1, 8, 5, 8], np.int32)
    jl, jc, tl, tc = _decode_pair(jm, jp, model, toks, pos, n_valid, 16)
    ids = tc["stack"]["pos_ids"].numpy()
    np.testing.assert_array_equal(ids, np.asarray(jc["stack"]["pos_ids"]))
    assert list(ids[0, 0, 8:]) == [14] + [-1] * 7
    _close(dt, tl, jl)


def test_paged_decode_equals_contiguous(pair):
    """The same ragged step on the page pool (pages permuted, a null page)
    through the paged-attention path gives the contiguous cache's logits
    and writes the same entries."""
    dt, _, _, model = pair
    B, T, ps = 3, 16, 4
    prompt = _tokens((B, 6), seed=5)
    _, cont = model.prefill({"tokens": prompt}, max_len=T)
    n = T // ps
    P = B * n
    pool = model.cache(P + 1, ps)
    perm = np.random.default_rng(6).permutation(P)
    bt = perm.reshape(B, n).astype(np.int32)
    for name, leaf in cont["stack"].items():
        pool["stack"][name][:, torch.as_tensor(bt).long()] = leaf.reshape(
            leaf.shape[0], B, n, ps, *leaf.shape[3:])
    bt[2, 2:] = P  # slot 2 owns two pages; the rest of its row is null
    toks = _tokens((B, 3), seed=7)
    pos = torch.tensor([6, 4, 6], dtype=torch.int32)
    nv = torch.tensor([3, 1, 2], dtype=torch.int32)
    lc, cont = model.decode(toks, cont, pos, n_valid=nv)
    before = PA.paged_attention.launches
    lp, pool = model.decode(toks, pool, pos, n_valid=nv,
                            block_table=torch.as_tensor(bt))
    assert PA.paged_attention.launches == before  # plain version on the CPU
    tol = 1e-5 if dt == "float32" else BF16_ATOL
    np.testing.assert_allclose(lp.float().numpy(), lc.float().numpy(),
                               rtol=tol, atol=tol)
    got = pool["stack"]["pos_ids"][:, torch.as_tensor(bt).long()]
    want = cont["stack"]["pos_ids"].reshape(-1, B, n, ps)
    np.testing.assert_array_equal(got[:, :2].numpy(), want[:, :2].numpy())
    np.testing.assert_array_equal(got[:, 2, :2].numpy(),
                                  want[:, 2, :2].numpy())


def test_params_tree_and_init():
    cfg = registry.get(ARCH).reduced()
    jm = JModel(jregistry.get(ARCH).reduced())
    model = Model(cfg, device="cpu")
    assert model.n_params() == jm.n_params()
    a, b = Model(cfg, device="cpu").init(5), model.init(5)
    names = dict(a.named_parameters())
    assert "blocks.stack.attn.wq" in names and "embed.embedding" in names
    assert names["blocks.stack.attn.wq"].shape == (2, 64, 4, 16)
    for n, p in b.named_parameters():
        assert torch.equal(p, names[n]), n
        assert p.dtype == torch.float32
    # the init rules: ones for norm scales, N(0, 1/fan_in) for the rest
    assert torch.equal(names["final_ln.scale"], torch.ones(64))
    std = names["blocks.stack.mlp.wd"].std().item()
    assert abs(std * np.sqrt(cfg.d_ff) - 1.0) < 0.05
    # the compute copy is cast once, to the config's dtype
    assert b.params["blocks"]["stack"]["mlp"]["wg"].dtype == torch.bfloat16
    assert b.params["blocks"]["stack"]["ln1"]["scale"].dtype == torch.float32


def test_from_reference_copies_the_tree():
    tree = {"a": {"b": np.arange(6, dtype=np.float32).reshape(2, 3)},
            "c": jnp.ones((2,), jnp.bfloat16)}
    out = pm.from_reference(tree)
    assert out["a"]["b"].dtype == torch.float32
    assert torch.equal(out["a"]["b"], torch.arange(6.0).reshape(2, 3))
    assert out["c"].dtype == torch.bfloat16


def test_device_rule_and_unported_families(monkeypatch):
    cfg = registry.get(ARCH).reduced()
    # MLA (deepseek-v2) and the multimodal families are ported: they build
    # on the CPU; only a family the reference does not know is refused
    for arch in ("deepseek-v2-236b", "llama-3.2-vision-11b",
                 "whisper-small"):
        model = Model(registry.get(arch).reduced(), device="cpu").init(0)
        assert model.n_params() > 0
    with pytest.raises(ValueError, match="family"):
        Model(cfg.replace(family="diffusion"), device="cpu")
    # the mixtral slice is ported: the moe family and the ring cache
    Model(registry.get("mixtral-8x7b").reduced(), device="cpu")
    assert attn.gqa_cache_init(cfg.replace(sliding_window=8), 1, 16,
                               torch.float32, plan=make_plan(cfg))[
        "k"].shape[1] == 8
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="no weights"):
        Model(cfg, device="cpu").apply({"tokens": _tokens((1, 4))})


@pytest.mark.parametrize("arch", sorted(registry.ARCHS))
def test_every_registry_config_builds_and_runs(arch):
    """Every config of the registry, reduced, builds on the CPU and runs its
    forward, a prefill and a decode step: finite logits of the padded
    vocabulary's width."""
    cfg = registry.get(arch).reduced()
    model = Model(cfg, device="cpu").init(0)
    rng = np.random.default_rng(0)
    batch = {"tokens": _tokens((2, 8))}
    if cfg.family == "vlm":
        batch["image_embeds"] = 0.1 * rng.standard_normal(
            (2, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        batch["audio_frames"] = 0.1 * rng.standard_normal(
            (2, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    logits, _ = model.apply(batch)
    V = -(-cfg.vocab_size // 128) * 128
    assert logits.shape == (2, 8, V)
    assert torch.isfinite(logits.float()).all()
    logits, cache = model.prefill(batch, max_len=12)
    logits, _ = model.decode(_tokens((2, 1)), cache, 8)
    assert logits.shape == (2, 1, V)
    assert torch.isfinite(logits.float()).all()


# --- the dense configs of other layer kinds ------------------------------------

@pytest.fixture(scope="module", params=["qwen3-1.7b", "nemotron-4-15b",
                                        "deepseek-67b"])
def dense_kind(request):
    """qk_norm with tied embeddings (qwen3), the relu2 MLP (nemotron) and
    deepseek-67b's config, reduced, float32: (JAX model, its params, the
    port's model)."""
    jcfg = jregistry.get(request.param).reduced().replace(dtype="float32")
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = registry.get(request.param).reduced().replace(dtype="float32")
    return jm, jp, Model(cfg, device="cpu").load_reference(
        jax.device_get(jp))


def test_dense_kind_apply(dense_kind):
    jm, jp, model = dense_kind
    toks = _tokens((4, 32))
    _close("float32", model.apply({"tokens": toks})[0],
           jm.apply(jp, {"tokens": toks})[0])


def test_dense_kind_prefill(dense_kind):
    jm, jp, model = dense_kind
    toks = _tokens((4, 32), seed=1)
    lengths = np.array([32, 20, 32, 7], np.int32)
    jl, jc = jm.prefill(jp, {"tokens": toks}, max_len=48, lengths=lengths)
    tl, tc = model.prefill({"tokens": toks}, max_len=48, lengths=lengths)
    _close("float32", tl, jl)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc["stack"][name].numpy(),
                                   np.asarray(jc["stack"][name]),
                                   rtol=1e-5, atol=1e-5)


def test_dense_kind_decode(dense_kind):
    jm, jp, model = dense_kind
    toks = _tokens((4, 16), seed=3)
    pos = np.array([6, 4, 0, 2], np.int32)
    n_valid = np.array([16, 1, 0, 9], np.int32)
    jl, jc, tl, tc = _decode_pair(jm, jp, model, toks, pos, n_valid, 32)
    _close("float32", tl, jl)
    np.testing.assert_array_equal(tc["stack"]["pos_ids"].numpy(),
                                  np.asarray(jc["stack"]["pos_ids"]))


# --- the recurrent families ---------------------------------------------------

RECURRENT = {
    "mamba2": lambda r: r.get("mamba2-780m").reduced(),
    "zamba2": lambda r: r.get("zamba2-1.2b").reduced(),
    "zamba2-tail": lambda r: dataclasses.replace(
        r.get("zamba2-1.2b").reduced(), num_layers=5),
}


@pytest.fixture(scope="module", params=sorted(RECURRENT))
def rec(request):
    """(JAX model, its params, the port's model on the CPU), float32."""
    jcfg = RECURRENT[request.param](jregistry).replace(dtype="float32")
    jm = JModel(jcfg)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    cfg = RECURRENT[request.param](registry).replace(dtype="float32")
    return jm, jp, Model(cfg, device="cpu").load_reference(jp)


REC_TOL = 5e-4


def _leaves_close(got, want, tol=REC_TOL):
    """Every leaf of the port's cache tree against the reference's."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _leaves_close(got[k], want[k], tol)
        return
    assert tuple(got.shape) == np.shape(want)
    if got.dtype == torch.int32:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=tol,
                                   atol=tol)


def test_recurrent_params_and_apply(rec):
    """The parameter tree and count, and the forward over two chunks of the
    scan (64 tokens, ``ssm_chunk`` 32)."""
    jm, jp, model = rec
    assert model.n_params() == jm.n_params()
    cfg = model.cfg
    if cfg.family == "hybrid":
        groups, tail = divmod(cfg.num_layers, cfg.hybrid_attn_every)
        blocks = model.weights()["blocks"]
        assert blocks["groups"]["ssm"]["wB"].shape == (
            groups, cfg.hybrid_attn_every, cfg.d_model, 1, cfg.ssm_state)
        assert (blocks["tail"] == {}) == (tail == 0)
    toks = _tokens((2, 64), seed=8)
    jl, _ = jm.apply(jp, {"tokens": toks})
    tl, _ = model.apply({"tokens": toks})
    _leaves_close(tl, jl)


def test_recurrent_prefill_seeds_the_state(rec):
    jm, jp, model = rec
    toks = _tokens((2, 32), seed=9)
    jl, jc = jm.prefill(jp, {"tokens": toks}, max_len=40)
    tl, tc = model.prefill({"tokens": toks}, max_len=40)
    _leaves_close(tl, jl)
    _leaves_close(tc, jc)


def test_recurrent_decode(rec):
    """A 7-token prefill, then three one-token steps at per-row positions
    (the hybrid's shared attention reads ``pos`` and ``n_valid``)."""
    jm, jp, model = rec
    prompt = _tokens((2, 7), seed=10)
    _, jc = jm.prefill(jp, {"tokens": prompt}, max_len=16)
    _, tc = model.prefill({"tokens": prompt}, max_len=16)
    for t in range(3):
        tok = _tokens((2, 1), seed=11 + t)
        pos = np.array([7 + t, 7 + t], np.int32)
        nv = np.array([1, 1], np.int32)
        jl, jc = jm.decode(jp, tok, jc, jnp.asarray(pos),
                           n_valid=jnp.asarray(nv))
        tl, tc = model.decode(tok, tc, torch.as_tensor(pos),
                              n_valid=torch.as_tensor(nv))
        _leaves_close(tl, jl)
    _leaves_close(tc, jc)
    with pytest.raises(ValueError, match="one token per step"):
        model.decode(_tokens((2, 2)), tc, 10)
