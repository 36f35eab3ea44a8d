"""The port's dense model (``repro_torch.models``) against the JAX package on
``llama3.2-1b.reduced()``, with the reference's parameters carried across by
``Model.load_reference`` (``params.from_reference``).

``apply``, ``prefill`` and ragged ``decode`` agree within 1e-5 in float32;
in bfloat16 (the working type) within atol 0.06 with top-1 agreement above
0.95, the reference's bound between its own bf16 tiers
(``tests/test_tolerance.py``, scan vs loop). On the CPU the model's causal
attention runs the flash kernel's plain version and the paged decode the
paged kernel's.
"""
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
    for arch, match in (("mixtral-8x7b", "mixtral"), ("mamba2-780m", "SSM"),
                        ("deepseek-v2-236b", "deepseek")):
        with pytest.raises(NotImplementedError, match=match):
            Model(registry.get(arch).reduced(), device="cpu")
    with pytest.raises(NotImplementedError, match="mixtral"):
        attn.gqa_cache_init(cfg.replace(sliding_window=8), 1, 16,
                            torch.float32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="no weights"):
        Model(cfg, device="cpu").apply({"tokens": _tokens((1, 4))})
