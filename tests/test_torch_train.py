"""The port's training path (``repro_torch.train``, ``repro_torch.data``,
``repro_torch.launch.train``, ``Model.loss_forward`` and the kernels'
autograd Functions) against the JAX package, on the CPU, on reduced
configs.

Tolerances, each with its reason:
- ``lm_loss``, the optimizers and the schedule: 1e-6 (float32, the same
  formulas term for term; XLA and PyTorch may sum a reduction in another
  order).
- The train step, float32, every leaf's gradient within ``GRAD_TOL`` of
  the largest magnitude of the reference's gradient of that leaf: 2e-5
  for the attention families (qk_norm and relu2 dense configs among
  them; measured at most 2.2e-6: reductions summed
  in other orders), 1e-3 for the recurrent ones (measured 1.7e-5 on mamba2
  and 3.0e-4 on zamba2's embedding: the scan's float32 sums run in the
  kernel's order, and the port with the reference-form ``ssd_chunked`` in
  its place lands 2.1e-4 away too). Loss and metrics within 1e-5 relative.
- Five steps of AdamW: losses within 1e-5 in float32 (measured 9.5e-7),
  0.02 in bfloat16 (measured 5.0e-3: the products and the casts'
  gradients round at other places).
- The Functions on the CPU: the flash backward against autograd through
  the float32 plain version within 1e-5 of each gradient's largest
  magnitude (another order of the same float32 sums), and in bfloat16
  against a float64 softmax attention within 2e-2 (inputs and outputs
  rounded to bfloat16, 2^-8 relative, and the bf16 forward's output in
  rowsum(dO o)); the scan backward against autograd through its plain
  version, bit for bit (it is that computation).
"""
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.data import pipeline as jdata
from repro.models.model import Model as JModel
from repro.train import loss as jloss
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch.configs import registry
from repro_torch.data import pipeline as data
from repro_torch.kernels import abft_matmul as AB
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import mamba_scan as MS
from repro_torch.kernels import overscale_matmul as OM
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import thermal_mg as MG
from repro_torch.kernels import thermal_stencil as TS
from repro_torch.launch import train as launch
from repro_torch.models import params as pm
from repro_torch.models.model import Model
from repro_torch.train import loss as loss_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import step as step_lib

FAMILIES = {"dense": "llama3.2-1b", "moe": "mixtral-8x7b",
            "mla": "deepseek-v2-236b", "ssm": "mamba2-780m",
            "hybrid": "zamba2-1.2b", "vlm": "llama-3.2-vision-11b",
            "audio": "whisper-small",
            # dense configs whose layers differ: qk_norm with tied
            # embeddings, and the relu2 MLP
            "qk_norm": "qwen3-1.7b", "relu2": "nemotron-4-15b"}
GRAD_TOL = {"ssm": 1e-3, "hybrid": 1e-3}
ATTN_GRAD_TOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small ops: with several test processes sharing the cores, torch
    runs these on one thread (no op here is large enough for its result to
    depend on the count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return pm.tree_map(lambda x: np.asarray(x), jax.device_get(tree))


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _ref_batch(jcfg, seq=32, batch=4, step=0):
    """The reference's batch (extras from ``jax.random``) as numpy."""
    dc = jdata.DataConfig(vocab_size=jcfg.vocab_size, seq_len=seq,
                          global_batch=batch, branch=2)
    it = jdata.make_iterator(jcfg, dc, start_step=step)
    return {k: np.asarray(v) for k, v in next(it).items()}


def _pair(arch, dtype="float32", seed=0, **kw):
    """(JAX model, its params, the port's model on the CPU, remat on)."""
    jcfg = jregistry.get(arch).reduced().replace(dtype=dtype, **kw)
    cfg = registry.get(arch).reduced().replace(dtype=dtype, remat="full",
                                               **kw)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    return jm, jp, Model(cfg, device="cpu").load_reference(_np(jp))


def _assert_tree_close(got, want, tol):
    """Every leaf of ``got`` (torch) within ``tol`` of the largest magnitude
    of the same leaf of ``want`` (numpy)."""
    g, w = pm.tree_leaves(got), pm.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        a = a.float().numpy()
        assert a.shape == b.shape
        scale = float(np.abs(b).max()) if b.size else 0.0
        assert np.abs(a - b).max() <= tol * scale + 1e-9, (
            np.abs(a - b).max(), scale)


# --- loss ---------------------------------------------------------------------

@pytest.mark.parametrize("pad", [0, 5, 64], ids=["none", "some", "all"])
def test_lm_loss_equals_reference(pad):
    """Masks (labels < 0), a padded vocabulary (labels below 200 of 256
    rows) and a batch with every label padded (the count clamps at 1)."""
    rng = np.random.default_rng(pad)
    logits = rng.normal(0, 3, (4, 16, 256)).astype(np.float32)
    labels = rng.integers(0, 200, (4, 16)).astype(np.int32)
    labels.reshape(-1)[rng.permutation(64)[:pad]] = -1
    want, wm = jloss.lm_loss(jnp.asarray(logits), jnp.asarray(labels))
    got, gm = loss_lib.lm_loss(torch.from_numpy(logits),
                               torch.from_numpy(labels))
    assert set(gm) == set(wm)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    for k in wm:
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=1e-6,
                                   atol=1e-7)
    assert float(gm["tokens"]) == max(64 - pad, 1)


def test_lm_loss_upcasts_bf16_logits():
    rng = np.random.default_rng(1)
    logits = torch.from_numpy(rng.normal(0, 3, (2, 8, 128))
                              .astype(np.float32)).bfloat16()
    labels = torch.from_numpy(rng.integers(0, 128, (2, 8)))
    got, _ = loss_lib.lm_loss(logits, labels)
    want, _ = loss_lib.lm_loss(logits.float(), labels)
    assert got.dtype == torch.float32 and torch.equal(got, want)


# --- optimizers -------------------------------------------------------------------

OPT_SHAPES = {"w": (4, 130), "b": (200, 140), "v": (130,), "s": (3, 2, 3)}


def _opt_case(seed=0):
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(0, 1, s).astype(np.float32)
              for k, s in OPT_SHAPES.items()}
    grads = [{k: rng.normal(0, 0.3, s).astype(np.float32)
              for k, s in OPT_SHAPES.items()} for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
@pytest.mark.parametrize("clip", [1.0, 100.0], ids=["clipped", "unclipped"])
def test_optimizer_updates_equal_reference(kind, clip):
    """Three steps from the same numpy gradients: parameters, moments and
    the metrics within 1e-6 (Adafactor: ``b`` factored, the rest not)."""
    oc_kw = dict(kind=kind, lr=1e-2, warmup_steps=2, total_steps=10,
                 grad_clip=clip)
    params, grads = _opt_case()
    jo = jopt.Optimizer(jopt.OptConfig(**oc_kw))
    to = opt_lib.Optimizer(opt_lib.OptConfig(**oc_kw))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jo.init(jp), to.init(tp)
    if kind == "adafactor":
        assert set(ts["b"]) == {"vr", "vc"} and set(ts["w"]) == {"v"}
    for step, g in enumerate(grads):
        jp, js, jm = jo.update(jp, {k: jnp.asarray(v) for k, v in g.items()},
                               js, step)
        tp, ts, tm = to.update(tp, {k: torch.from_numpy(v)
                                    for k, v in g.items()}, ts, step)
        _assert_tree_close(tp, _np(jp), 1e-6)
        _assert_tree_close(ts, _np(js), 1e-6)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)


@pytest.mark.parametrize("step", [0, 1, 4, 9, 10, 50, 100, 101])
def test_lr_schedule_equals_reference(step):
    oc = dict(lr=1.0, warmup_steps=10, total_steps=100)
    want = float(jopt.lr_schedule(jopt.OptConfig(**oc), jnp.int32(step)))
    got = float(opt_lib.lr_schedule(opt_lib.OptConfig(**oc), step))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-7)


def test_clip_by_global_norm_equals_reference():
    _, grads = _opt_case(3)
    for max_norm in (0.5, 1e3):
        jg, jn = jopt.clip_by_global_norm(
            {k: jnp.asarray(v) for k, v in grads[0].items()}, max_norm)
        tg, tn = opt_lib.clip_by_global_norm(
            {k: torch.from_numpy(v) for k, v in grads[0].items()}, max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        _assert_tree_close(tg, _np(jg), 1e-6)


def test_state_meta_equals_reference():
    """The state's ParamMeta tree, factored and not, for llama's reduced
    parameters."""
    cfg = registry.get("llama3.2-1b").reduced()
    meta = Model(cfg, device="cpu").param_meta()
    jmeta = JModel(jregistry.get("llama3.2-1b").reduced()).param_meta()
    for kind in ("adamw", "adafactor"):
        oc = dict(kind=kind, min_dim_factored=64)
        got = opt_lib.Optimizer(opt_lib.OptConfig(**oc)).state_meta(meta)
        want = jopt.Optimizer(jopt.OptConfig(**oc)).state_meta(jmeta)
        g = pm.tree_leaves(got)
        w = jax.tree_util.tree_leaves(
            want, is_leaf=lambda x: hasattr(x, "logical"))
        assert [(m.shape, m.logical, m.dtype) for m in g] == \
            [(m.shape, m.logical, m.dtype) for m in w]


# --- the substrate tests, mirrored (tests/test_substrate.py) ---------------------

@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_converges_on_quadratic(kind):
    def quad(p):
        return torch.sum(torch.square(p["w"] - 3.0)) + torch.sum(
            torch.square(p["b"] + 1.0))

    oc = opt_lib.OptConfig(kind=kind, lr=0.1, warmup_steps=0,
                           total_steps=10_000, weight_decay=0.0,
                           grad_clip=100.0)
    opt = opt_lib.Optimizer(oc)
    params = {"w": torch.zeros((4, 130)), "b": torch.zeros((200, 140))}
    state = opt.init(params)
    for i in range(200):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        g = torch.autograd.grad(quad(leaves), list(leaves.values()))
        params, state, _ = opt.update(params, dict(zip(leaves, g)), state, i)
    assert float(quad(params)) < 0.3


def test_grad_clip_norm():
    opt = opt_lib.Optimizer(opt_lib.OptConfig(grad_clip=1.0))
    params = {"w": torch.zeros((4,))}
    _, _, metrics = opt.update(params, {"w": torch.full((4,), 100.0)},
                               opt.init(params), 0)
    assert float(metrics["grad_norm"]) == pytest.approx(200.0)


def test_lr_schedule_shape():
    oc = opt_lib.OptConfig(lr=1.0, warmup_steps=10, total_steps=100)
    assert float(opt_lib.lr_schedule(oc, 0)) == pytest.approx(0.1)
    assert float(opt_lib.lr_schedule(oc, 9)) == pytest.approx(1.0)
    assert float(opt_lib.lr_schedule(oc, 100)) == pytest.approx(0.0,
                                                                abs=1e-6)


def test_adafactor_memory_factored():
    opt = opt_lib.Optimizer(opt_lib.OptConfig(kind="adafactor"))
    sm = opt.state_meta({"w": pm.ParamMeta((1024, 2048), (None, None))})
    assert sm["w"]["vr"].shape == (1024,)
    assert sm["w"]["vc"].shape == (2048,)


def _dc(**kw):
    return data.DataConfig(**kw)


def test_data_deterministic():
    dc = _dc(vocab_size=128, seq_len=16, global_batch=4, seed=3)
    a = data.SyntheticLM(dc, "cpu").batch(5)
    b = data.SyntheticLM(dc, "cpu").batch(5)
    assert torch.equal(a["tokens"], b["tokens"])


def test_data_labels_shifted():
    b = data.SyntheticLM(_dc(vocab_size=128, seq_len=16, global_batch=2),
                         "cpu").batch(0)
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_data_bigram_structure_learnable():
    dc = _dc(vocab_size=64, seq_len=32, global_batch=4, branch=2)
    src = data.SyntheticLM(dc, "cpu")
    b = src.batch(0)
    toks, labels = b["tokens"].numpy(), b["labels"].numpy()
    for t in range(dc.seq_len):
        assert all(labels[i, t] in src.successors[toks[i, t]]
                   for i in range(4))


def test_data_shards_distinct():
    src = data.SyntheticLM(_dc(vocab_size=128, seq_len=16, global_batch=8),
                           "cpu")
    s0 = src.batch(1, shard=0, n_shards=2)
    s1 = src.batch(1, shard=1, n_shards=2)
    assert s0["tokens"].shape == (4, 16)
    assert not torch.equal(s0["tokens"], s1["tokens"])
    with pytest.raises(ValueError, match="divide"):
        src.batch(1, n_shards=3)


@pytest.mark.parametrize("step,shard,n", [(0, 0, 1), (7, 1, 2), (3, 3, 4)])
def test_batches_equal_reference_bit_for_bit(step, shard, n):
    for seed in (0, 5):
        kw = dict(vocab_size=500, seq_len=24, global_batch=8, seed=seed,
                  branch=3)
        want = jdata.SyntheticLM(jdata.DataConfig(**kw)).batch(step, shard,
                                                                n)
        got = data.SyntheticLM(_dc(**kw), "cpu").batch(step, shard, n)
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-small"])
def test_iterator_stub_extras(arch):
    """The stubs' shapes and scale, drawn per step from a generator: the
    same step twice gives the same draw, the next step another."""
    cfg = registry.get(arch).reduced()
    dc = _dc(vocab_size=cfg.vocab_size, seq_len=8, global_batch=2)
    key = "image_embeds" if cfg.family == "vlm" else "audio_frames"
    a, b = (next(data.make_iterator(cfg, dc, device="cpu")) for _ in "ab")
    c = next(data.make_iterator(cfg, dc, start_step=1, device="cpu"))
    frames = cfg.num_image_tokens if cfg.family == "vlm" \
        else cfg.encoder_frames
    assert a[key].shape == (2, frames, cfg.d_model)
    assert torch.equal(a[key], b[key]) and not torch.equal(a[key], c[key])
    assert 0.05 < float(a[key].std()) < 0.15


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-780m",
                                  "mixtral-8x7b"])
def test_loss_decreases(arch):
    """``tests/test_archs_smoke.py::test_loss_decreases`` on the port: 30
    AdamW steps in the config's bf16 over the bigram stream."""
    cfg = registry.get(arch).reduced()
    model = Model(cfg, device="cpu").init(0)
    opt = opt_lib.make_optimizer(cfg, lr=3e-3, warmup_steps=5,
                                 total_steps=60)
    step = step_lib.make_train_step(model, opt, n_accum=1)
    params = model.weights()
    state = opt.init(params)
    dc = _dc(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8,
             branch=2)
    it = data.make_iterator(cfg, dc, device="cpu")
    losses = []
    for i in range(30):
        params, state, m = step(params, state, next(it), i)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses[::6]


# --- the train step against the reference's ---------------------------------------

@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    """(family, JAX model, its params, the port's model, the reference's
    batch, its jitted value_and_grad)."""
    jm, jp, model = _pair(FAMILIES[request.param])
    batch = _ref_batch(jm.cfg)
    vg = jax.jit(jax.value_and_grad(jstep.make_loss_fn(jm), has_aux=True))
    return request.param, jm, jp, model, batch, vg


@pytest.mark.parametrize("n_accum", [1, 2])
def test_train_step_gradients_equal_reference(family, n_accum):
    """Loss, metrics and every leaf's float32 gradient of
    ``make_grad_fn`` (remat on: each block under checkpointing) against
    ``jax.value_and_grad`` of the reference's loss, summed over the
    microbatches in order and divided as the reference's scan does."""
    name, jm, jp, model, batch, vg = family
    ref = []
    for mb in step_lib._split_batch(batch, n_accum):
        (l, m), g = vg(jp, mb)
        ref.append((float(l), {k: float(v) for k, v in m.items()}, _np(g)))
    it = iter([sum(gs) / n_accum for gs in zip(
        *(pm.tree_leaves(r[2]) for r in ref))])
    want_g = pm.tree_map(lambda _: next(it), ref[0][2])
    want_l = sum(r[0] for r in ref) / n_accum
    loss, metrics, grads = step_lib.make_grad_fn(model, n_accum)(
        model.weights(), _torch_batch(batch))
    assert set(metrics) == set(ref[0][1])
    np.testing.assert_allclose(float(loss), want_l, rtol=1e-5)
    for k in metrics:
        want = sum(r[1][k] for r in ref) / n_accum
        np.testing.assert_allclose(float(metrics[k]), want, rtol=1e-5,
                                   atol=1e-6)
    _assert_tree_close(grads, want_g, GRAD_TOL.get(name, ATTN_GRAD_TOL))
    assert all(g.dtype == torch.float32 for g in pm.tree_leaves(grads))


def test_remat_changes_no_gradient():
    """Checkpointed blocks recompute the same forward: loss and gradients
    equal bit for bit with remat on and off."""
    _, _, model = _pair("llama3.2-1b")
    batch = _torch_batch(_ref_batch(model.cfg))
    outs = []
    for remat in ("full", "none"):
        model.cfg = model.cfg.replace(remat=remat)
        outs.append(step_lib.make_grad_fn(model)(model.weights(), batch))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(
        pm.tree_leaves(outs[0][2]), pm.tree_leaves(outs[1][2])))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 0.02)])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "mixtral-8x7b"])
def test_five_steps_equal_reference(arch, dtype, tol):
    """Five AdamW steps (global batch 8 as 2 microbatches of 4): the
    losses of the port's step and the reference's jitted step."""
    jm, jp, model = _pair(arch, dtype)
    kw = dict(lr=3e-3, warmup_steps=5, total_steps=60)
    jo = jopt.make_optimizer(jm.cfg, **kw)
    jtrain = jax.jit(jstep.make_train_step(jm, jo, n_accum=2))
    js = jo.init(jp)
    opt = opt_lib.make_optimizer(model.cfg, **kw)
    train = step_lib.make_train_step(model, opt, n_accum=2)
    params = model.weights()
    state = opt.init(params)
    for i in range(5):
        b = _ref_batch(jm.cfg, batch=8, step=i)
        jp, js, jmet = jtrain(jp, js, b, i)
        params, state, met = train(params, state, _torch_batch(b), i)
        assert abs(float(met["loss"]) - float(jmet["loss"])) <= tol, i


def test_weights_after_a_step_serve_the_update():
    """After a step ``Model.apply`` reads the updated masters: it equals a
    fresh model loaded with them, and no longer the initial forward."""
    _, _, model = _pair("llama3.2-1b")
    batch = _torch_batch(_ref_batch(model.cfg))
    before, _ = model.apply(batch)
    opt = opt_lib.make_optimizer(model.cfg, lr=1e-2, warmup_steps=0)
    train = step_lib.make_train_step(model, opt)
    params, _, _ = train(model.weights(), opt.init(model.weights()), batch,
                         0)
    after, _ = model.apply(batch)
    fresh = Model(model.cfg, device="cpu").load_reference(
        pm.tree_map(lambda t: t.numpy().copy(), params))
    want, _ = fresh.apply(batch)
    assert torch.equal(after, want)
    assert not torch.equal(after, before)
    # the stored weights are the masters themselves, not a copy
    assert all(a.data_ptr() == b.data_ptr() for a, b in zip(
        pm.tree_leaves(model.weights()), pm.tree_leaves(params)))


def test_eval_step_equals_reference():
    jm, jp, model = _pair("llama3.2-1b")
    batch = _ref_batch(jm.cfg)
    want = jstep.make_eval_step(jm)(jp, batch)
    got = step_lib.make_eval_step(model)(model.weights(),
                                         _torch_batch(batch))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5)
    assert not got["loss"].requires_grad


# --- the kernels' Functions ------------------------------------------------------

def _attn64(q, k, v, causal):
    """Softmax attention in float64, materialised."""
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    heads = torch.arange(H) // (H // Hkv)
    s = torch.einsum("bshd,bthd->bhst", q.double(),
                     k.double()[:, :, heads]) / math.sqrt(D)
    if causal:
        s = s.masked_fill(torch.arange(T)[None] > torch.arange(S)[:, None],
                          float("-inf"))
    return torch.einsum("bhst,bthd->bshd", torch.softmax(s, -1),
                        v.double()[:, :, heads])


FLASH_CASES = [(True, 40, 40, 4, 2, 16), (False, 24, 37, 4, 4, 32),
               (False, 1, 70, 8, 2, 16)]


def _flash_inputs(S, T, H, Hkv, D, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=g).to(dtype).requires_grad_()
    return mk(2, S, H, D), mk(2, T, Hkv, D), mk(2, T, Hkv, D), \
        torch.randn((2, S, H, D), generator=g).to(dtype)


@pytest.mark.parametrize("causal,S,T,H,Hkv,D", FLASH_CASES)
def test_flash_function_backward_equals_autograd_float32(causal, S, T, H,
                                                         Hkv, D):
    q, k, v, do = _flash_inputs(S, T, H, Hkv, D, torch.float32)
    o = FA.flash_attention(q, k, v, causal=causal)
    assert o.grad_fn is not None
    got = torch.autograd.grad(o, (q, k, v), do)
    ref = FA.flash_attention_ref(q, k, v, causal=causal)
    assert torch.equal(o, ref)  # the forward is the plain version
    want = torch.autograd.grad(ref, (q, k, v), do)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()
    # the row blocks bound the scores: one row at a time gives the same
    blocked = FA.flash_attention_backward(q.detach(), k.detach(),
                                          v.detach(), o.detach(), do,
                                          causal=causal, block=1)
    for a, b in zip(blocked, got):
        assert (a - b).abs().max() <= 1e-6 * b.abs().max()


@pytest.mark.parametrize("causal,S,T,H,Hkv,D", FLASH_CASES[:2])
def test_flash_function_backward_bf16_against_float64(causal, S, T, H, Hkv,
                                                      D):
    q, k, v, do = _flash_inputs(S, T, H, Hkv, D, torch.bfloat16, seed=1)
    o = FA.flash_attention(q, k, v, causal=causal)
    got = torch.autograd.grad(o, (q, k, v), do)
    want = torch.autograd.grad(_attn64(q, k, v, causal), (q, k, v),
                               do.double())
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        assert (a.double() - b).abs().max() <= 2e-2 * b.abs().max()


@pytest.mark.parametrize("G,chunk", [(2, 16), (4, 32)])
def test_scan_function_backward_equals_autograd(G, chunk):
    g = torch.Generator().manual_seed(G)
    b, S, H, P, N = 2, 32, 4, 8, 16
    xh = torch.randn((b, S, H, P), generator=g).requires_grad_()
    dt = torch.rand((b, S, H), generator=g).requires_grad_()
    A = (-torch.rand((H,), generator=g)).requires_grad_()
    Bm = torch.randn((b, S, G, N), generator=g).requires_grad_()
    Cm = torch.randn((b, S, G, N), generator=g).requires_grad_()
    y, state = MS.mamba_scan(xh, dt, A, Bm, Cm, chunk=chunk)
    assert y.grad_fn is not None and not state.requires_grad
    dy = torch.randn(y.shape, generator=g)
    got = torch.autograd.grad(y, (xh, dt, A, Bm, Cm), dy)
    ref, ref_state = MS.mamba_scan_ref(xh, dt, A, Bm, Cm, chunk=chunk)
    assert torch.equal(y, ref) and torch.equal(state, ref_state)
    want = torch.autograd.grad(ref, (xh, dt, A, Bm, Cm), dy)
    assert all(torch.equal(a, w) for a, w in zip(got, want))
    # a partial request: only the inputs that require a gradient get one
    y2, _ = MS.mamba_scan(xh, dt.detach(), A.detach(), Bm, Cm.detach(),
                          chunk=chunk)
    part = torch.autograd.grad(y2, (xh, Bm), dy)
    assert torch.equal(part[0], want[0]) and torch.equal(part[1], want[3])


def test_no_grad_calls_skip_the_functions():
    """Serving runs without autograd: the wrappers return the plain result
    with no graph, as before."""
    q, k, v, _ = _flash_inputs(8, 8, 2, 2, 16, torch.float32)
    with torch.no_grad():
        o = FA.flash_attention(q, k, v)
    assert o.grad_fn is None


def _other_wrapper_calls():
    """(name, call) of each kernel wrapper without a Function, on CPU
    inputs of which one requires a gradient."""
    f = torch.float32
    q = torch.randn(2, 1, 4, 16, requires_grad=True)
    pool = torch.randn(3, 16, 2, 16)
    ids = torch.zeros(3, 16, dtype=torch.int32)
    bt = torch.zeros(2, 1, dtype=torch.int32)
    pos = torch.zeros(2, 1, dtype=torch.int32)
    a = torch.zeros(4, 8, dtype=torch.int8)
    b = torch.zeros(8, 4, dtype=torch.int8)
    u = torch.zeros(4, 4, dtype=torch.int32)
    cdf = torch.linspace(0, 1, 33, dtype=f).requires_grad_()
    T = torch.full((1, 8, 8), 25.0, requires_grad=True)
    from repro_torch.core import thermal as TT
    tc = TT.ThermalConfig(theta_ja=12.0, coarse_cells=64)
    g_v, g_lat = TT.conductances(23, 17, tc)
    plan = TT._plan_on(23, 17, g_v, g_lat, 64, torch.device("cpu"))
    rhs = torch.ones((1, 23, 17), requires_grad=True)
    return [
        ("paged_attention",
         lambda: PA.paged_attention(q, pool, pool, ids, bt, pos)),
        ("overscale_matmul", lambda: OM.overscale_matmul(a, b, u, u, cdf)),
        ("abft_matmul", lambda: AB.abft_matmul(a, b, u, u, cdf)),
        ("thermal_stencil", lambda: TS.thermal_stencil(
            T, torch.ones(8, 8), torch.full((8, 8), 4.0), g_lat=1.0,
            g_v_tamb=0.0, iters=2)),
        ("thermal_mg_solve", lambda: MG.thermal_mg_solve(
            rhs, None, plan, tol=tc.tol, max_cycles=2, n_smooth=2)),
    ]


@pytest.mark.parametrize("i", range(5))
def test_wrappers_without_a_function_refuse_grad(i):
    """A kernel's output carries no gradient: each wrapper without a
    Function raises where one is wanted, and runs under no_grad."""
    name, call = _other_wrapper_calls()[i]
    with pytest.raises(RuntimeError, match=f"{name} has no backward"):
        call()
    with torch.no_grad():
        call()


# --- the CLI ------------------------------------------------------------------------

def test_cli_resume_and_retry(tmp_path, capsys):
    """``main`` on the CPU: an injected failure is retried, a run stopped
    at step 4 resumes from its checkpoint and ends where an uninterrupted
    run ends, bit for bit; the energy policy closes the control loop."""
    base = ["--device", "cpu", "--seq", "16", "--batch", "4",
            "--log-every", "1", "--checkpoint-every", "2"]
    whole = launch.main(base + ["--steps", "6", "--checkpoint-dir",
                                str(tmp_path / "a")])
    first = launch.main(base + ["--steps", "4", "--checkpoint-dir",
                                str(tmp_path / "b"),
                                "--inject-failure-at", "1",
                                "--energy-policy", "power_save"])
    out = capsys.readouterr().out
    assert "[ft] step 1 attempt 0 failed" in out
    assert "energy[power_save]" in out and "ctl[solver]" in out
    resumed = launch.main(base + ["--steps", "6", "--checkpoint-dir",
                                  str(tmp_path / "b"), "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out
    assert first is not None and resumed == whole


def test_cli_does_not_retry_the_update(monkeypatch):
    """A transient failure inside the optimizer's update, which writes the
    masters and moments in place, ends the run: a retry would step the
    leaves already written a second time. Only the gradients are retried."""
    from repro_torch.ft.monitor import TransientError
    calls = []

    def failing(self, *args):
        calls.append(args[-1])
        raise TransientError("inside the update")

    monkeypatch.setattr(opt_lib.Optimizer, "update", failing)
    with pytest.raises(TransientError, match="inside the update"):
        launch.main(["--device", "cpu", "--seq", "16", "--batch", "4",
                     "--steps", "2", "--inject-failure-at", "0"])
    assert calls == [0]


def test_cli_refuses_model_parallel():
    """Without a process group (no torchrun environment, none initialised)
    ``--model-parallel 2`` raises: the CLI never runs one rank in place of
    many (``tests/test_torch_spmd_train.py`` trains under a world)."""
    import torch.distributed as dist
    assert not dist.is_initialized() and "WORLD_SIZE" not in os.environ
    with pytest.raises(RuntimeError, match="process group"):
        launch.main(["--device", "cpu", "--model-parallel", "2"])
