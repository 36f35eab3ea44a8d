"""The error-injected int8 matmuls of the port against the JAX package.

The plain versions (``overscale_matmul_ref``, ``abft_matmul_ref``) must
equal the reference's oracles (``repro.kernels.ref``) and its Pallas kernels
in interpret mode exactly: every output is an int32 decided by integer
arithmetic and a float32 comparison rounded the same way. The helpers
(``bit_probs_to_cdf``, ``quantize``, ``checksum_refs``) are equal bit for
bit; the quantile, rounded as ``jnp.quantile`` rounds it, agrees within
1e-6 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import apps as JA
from repro.core import overscaling as JOS
from repro.core import netlist as JNL
from repro.core import thermal as JT
from repro.core import tpu_fleet as JTF
from repro.kernels import ref as kref
from repro.kernels.abft_matmul import abft_matmul as jabft
from repro.kernels.abft_matmul import checksum_refs as jchecksum_refs
from repro.kernels.overscale_matmul import bit_probs_to_cdf as jcdf
from repro.kernels.overscale_matmul import make_int8_error_matmul
from repro.kernels.overscale_matmul import overscale_matmul as jomm
from repro.kernels.overscale_matmul import quantize as jquantize
from repro.tolerance import TimingFaultModel as JTimingFaultModel
from repro_torch.kernels import abft_matmul as AB
from repro_torch.kernels import ops
from repro_torch.kernels import overscale_matmul as OM


def _case(M, K, N, seed, lo=-128, hi=127):
    rng = np.random.default_rng(seed)
    a = rng.integers(lo, hi + 1, (M, K)).astype(np.int8)
    b = rng.integers(lo, hi + 1, (K, N)).astype(np.int8)
    ug = rng.integers(0, 2 ** 32, (M, N), dtype=np.uint64).astype(np.uint32)
    ub = rng.integers(0, 2 ** 32, (M, N), dtype=np.uint64).astype(np.uint32)
    return a, b, ug, ub


def _t(x):
    """numpy -> torch; uint32 planes as int32 holding the same bits."""
    x = np.asarray(x)
    if x.dtype == np.uint32:
        x = x.view(np.int32)
    return torch.from_numpy(np.array(x, copy=True))


def _tail(lo, p):
    probs = np.zeros(32)
    probs[lo:] = p
    return probs


PROBS = {
    "zero": np.zeros(32),
    "tail24": _tail(24, 0.02),
    "bit30": np.eye(32)[30] * 0.05,
    "random": np.random.default_rng(5).uniform(0, 2e-3, 32),
}

# (M, K, N): tests/test_kernels.py's cases, LeNet's three products at 8
# images (conv1, conv2, fc), and odd edges
SHAPES = [(64, 96, 80), (200, 128, 130), (128, 256, 128),
          (2048, 9, 8), (512, 72, 16), (8, 256, 10), (1, 1, 1), (33, 5, 70)]


@pytest.mark.parametrize("M,K,N", SHAPES)
@pytest.mark.parametrize("profile", sorted(PROBS))
def test_plain_equals_reference_oracle(M, K, N, profile):
    a, b, ug, ub = _case(M, K, N, seed=M * 7 + N)
    cdf = jcdf(PROBS[profile])
    want = np.asarray(kref.overscale_matmul_ref(a, b, ug, ub, cdf))
    got = OM.overscale_matmul_ref(_t(a), _t(b), _t(ug), _t(ub),
                                  OM.bit_probs_to_cdf(PROBS[profile], "cpu"))
    np.testing.assert_array_equal(got.numpy(), want)
    c, rs, cs = kref.abft_matmul_ref(a, b, ug, ub, cdf)
    gc, grs, gcs = AB.abft_matmul_ref(
        _t(a), _t(b), _t(ug), _t(ub),
        OM.bit_probs_to_cdf(PROBS[profile], "cpu"))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(c))
    np.testing.assert_array_equal(grs.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(gcs.numpy(), np.asarray(cs))


@pytest.mark.parametrize("M,K,N", [(64, 96, 80), (200, 128, 130),
                                   (512, 72, 16)])
def test_plain_equals_interpret_mode_kernels(M, K, N):
    a, b, ug, ub = _case(M, K, N, seed=3)
    probs = PROBS["tail24"]
    out_k = np.asarray(jomm(a, b, ug, ub, jcdf(probs), interpret=True))
    c_k, rs_k, cs_k = jabft(a, b, ug, ub, jcdf(probs), interpret=True)
    args = (_t(a), _t(b), _t(ug), _t(ub), OM.bit_probs_to_cdf(probs, "cpu"))
    np.testing.assert_array_equal(ops.overscale_mm(*args).numpy(), out_k)
    got = ops.abft_mm(*args)
    for g, w in zip(got, (c_k, rs_k, cs_k)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_product_wraps_mod_2_32():
    # K = 2^17 products of (-128)(-128) = 2^31 per element: one past
    # INT32_MAX, so the accumulator wraps to -2^31; the row sums of eight
    # such elements wrap again
    M = N = 8
    K = 1 << 17
    a = np.full((M, K), -128, np.int8)
    b = np.full((K, N), -128, np.int8)
    ug = np.full((M, N), 0xFFFFFFFF, np.uint32)  # never flips
    ub = np.zeros((M, N), np.uint32)
    cdf = jcdf(PROBS["tail24"])
    c, rs, cs = kref.abft_matmul_ref(a, b, ug, ub, cdf)
    got = AB.abft_matmul_ref(_t(a), _t(b), _t(ug), _t(ub),
                             OM.bit_probs_to_cdf(PROBS["tail24"], "cpu"))
    assert int(got[0][0, 0]) == -2 ** 31
    for g, w in zip(got, (c, rs, cs)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_bit_index_at_an_exact_cdf_entry():
    # cdf[29] = 0.125, cdf[30] = 0.25, cdf[31] = cdf[32] = 0.5: u_bit = 2^30
    # gives u2 = 0.25 * 0.5 = 0.125 == cdf[29] exactly (counted: bit 29);
    # the next float32 below it gives bit 28
    probs = np.zeros(32)
    probs[28], probs[29], probs[30] = 0.125, 0.125, 0.25
    a = np.zeros((1, 4), np.int8)
    b = np.zeros((4, 3), np.int8)
    ug = np.zeros((1, 3), np.uint32)  # u = 0 < p_total: always flips
    ub = np.array([[1 << 30, (1 << 30) - 64, 0xFFFFFFFF]], np.uint32)
    want = np.asarray(kref.overscale_matmul_ref(a, b, ug, ub, jcdf(probs)))
    got = OM.overscale_matmul(_t(a), _t(b), _t(ug), _t(ub),
                              OM.bit_probs_to_cdf(probs, "cpu")).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.view(np.uint32).tolist() == [[1 << 29, 1 << 28, 1 << 31]]


def test_zero_probs_is_the_exact_product_and_clean_output():
    a, b, ug, ub = _case(64, 64, 64, seed=9)
    c, clean = OM.overscale_matmul(_t(a), _t(b), _t(ug), _t(ub),
                                   OM.bit_probs_to_cdf(np.zeros(32), "cpu"),
                                   return_clean=True)
    exact = a.astype(np.int64) @ b.astype(np.int64)
    np.testing.assert_array_equal(c.numpy(), exact.astype(np.int32))
    np.testing.assert_array_equal(clean.numpy(), c.numpy())
    _, clean = OM.overscale_matmul(_t(a), _t(b), _t(ug), _t(ub),
                                   OM.bit_probs_to_cdf(PROBS["bit30"], "cpu"),
                                   return_clean=True)
    np.testing.assert_array_equal(clean.numpy(), exact.astype(np.int32))


def test_flip_rate_tracks_probability():
    M = K = N = 256
    a = np.ones((M, K), np.int8)
    b = np.ones((K, N), np.int8)
    rng = np.random.default_rng(51)
    ug, ub = (rng.integers(0, 2 ** 32, (M, N), dtype=np.uint64)
              .astype(np.uint32) for _ in range(2))
    out = OM.overscale_matmul(
        _t(a), _t(b), _t(ug), _t(ub),
        OM.bit_probs_to_cdf(PROBS["bit30"], "cpu")).numpy()
    assert float((out != K).mean()) == pytest.approx(0.05, abs=0.01)
    assert set(np.unique(out ^ K).tolist()) == {0, 1 << 30}


def _profiles():
    """The cdfs the port's main path builds: Fig 8's LeNet profile at each
    budget after ``scale_bit_probs``, and §V's fault-model profiles."""
    tc = JT.ThermalConfig(theta_ja=12.0)
    out = {f"fig8_lenet_g{r.gamma}": JA.scale_bit_probs(r.bit_probs)
           for r in JOS.sweep(JNL.generate(JA.LENET_STATS), [1.2, 1.35],
                              t_amb=40.0, tc=tc)}
    fm = JTimingFaultModel()
    for vc in (0.725, 0.715, 0.70):
        out[f"sec5_{vc}"] = fm.bit_probs(vc, JTF.V_SRAM_NOM, 65.0)
    out.update(PROBS)
    return out


def test_bit_probs_to_cdf_bit_for_bit():
    for name, probs in _profiles().items():
        want = np.asarray(jcdf(probs))
        got = OM.bit_probs_to_cdf(probs, "cpu").numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=name)
    rng = np.random.default_rng(0)
    for _ in range(200):
        probs = rng.uniform(0, 10.0 ** rng.uniform(-6, 0), 32)
        np.testing.assert_array_equal(
            OM.bit_probs_to_cdf(probs, "cpu").numpy(),
            np.asarray(jcdf(probs)))
    with pytest.raises(ValueError):
        OM.bit_probs_to_cdf(np.zeros(16), "cpu")


def test_bit_probs_to_cdf_device(monkeypatch):
    """``device="cpu"`` gives the reference's cdf on the CPU; the default
    is the card, and without one the call raises."""
    probs = PROBS["tail24"]
    got = OM.bit_probs_to_cdf(probs, device="cpu")
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(jcdf(probs)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OM.bit_probs_to_cdf(probs)


@pytest.mark.parametrize("shape,scale", [((64, 64), 1.0), ((2048, 9), 3.0),
                                         ((256, 10), 0.05)])
def test_quantize_bit_for_bit(shape, scale):
    x = (np.random.default_rng(61).standard_normal(shape) * scale).astype(
        np.float32)
    q, s = jquantize(jnp.asarray(x))
    tq, ts = OM.quantize(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
    assert float(ts) == float(s)


@pytest.mark.parametrize("M,K,N", [(16, 12, 20), (48, 64, 40), (8, 2048, 64)])
def test_checksum_refs_bit_for_bit(M, K, N):
    a, b, _, _ = _case(M, K, N, seed=2)
    want = jchecksum_refs(jnp.asarray(a), jnp.asarray(b))
    got = AB.checksum_refs(_t(a), _t(b))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_checksum_refs_wrap():
    a = np.full((4, 1 << 14), 127, np.int8)
    b = np.full((1 << 14, 1 << 10), 127, np.int8)
    got = AB.checksum_refs(_t(a), _t(b))
    want = jchecksum_refs(jnp.asarray(a), jnp.asarray(b))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n", [1, 2, 100, 2001, 16384, 65536 * 3 + 7])
def test_quantile_matches_jnp(n):
    x = np.abs(np.random.default_rng(n).integers(-2 ** 26, 2 ** 26, n)
               ).astype(np.float32)
    got = OM.quantile_linear(torch.from_numpy(x), OM.CLIP_QUANTILE)
    assert got.dtype == torch.float32 and got.dim() == 0
    want = float(jnp.quantile(jnp.asarray(x), OM.CLIP_QUANTILE))
    assert float(got) == pytest.approx(want, rel=1e-6)


def test_make_int8_error_matmul_matches_reference_with_replayed_planes():
    key = jax.random.PRNGKey(3)
    probs = JA.scale_bit_probs(_tail(20, 30.0))  # ~5 % of elements flip
    ref_mm = make_int8_error_matmul(probs, key)
    mm = OM.make_int8_error_matmul(probs, seed=0, planes=jax_planes(key),
                                   device="cpu")
    rng = np.random.default_rng(8)
    for M, K, N in [(2048, 9, 8), (512, 72, 16), (8, 256, 10)]:
        a = rng.standard_normal((M, K)).astype(np.float32)
        b = rng.standard_normal((K, N)).astype(np.float32)
        want = np.asarray(ref_mm(jnp.asarray(a), jnp.asarray(b)))
        got = mm(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def jax_planes(key):
    """The reference's planes of its n-th call (``fold_in(key, n)``)."""
    def planes(n, shape):
        k1, k2 = jax.random.split(jax.random.fold_in(key, n))
        return tuple(_t(np.asarray(jax.random.bits(k, shape, jnp.uint32)))
                     for k in (k1, k2))
    return planes


def test_random_planes_are_seeded_and_cover_32_bits():
    g1, g2 = torch.Generator(), torch.Generator()
    g1.manual_seed(4)
    g2.manual_seed(4)
    a = OM.random_planes(g1, (64, 64), "cpu")
    b = OM.random_planes(g2, (64, 64), "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1])
    u = OM.u32_to_f32(a[0]) * OM.TWO_POW_M32
    assert 0.0 <= float(u.min()) < 0.01 and 0.99 < float(u.max()) <= 1.0


def test_cpu_runs_the_plain_version_and_launches_nothing():
    a, b, ug, ub = _case(16, 16, 16, seed=1)
    args = (_t(a), _t(b), _t(ug), _t(ub),
            OM.bit_probs_to_cdf(PROBS["tail24"], "cpu"))
    before = (OM.overscale_matmul.launches, AB.abft_matmul.launches)
    assert torch.equal(OM.overscale_matmul(*args),
                       OM.overscale_matmul_ref(*args))
    AB.abft_matmul(*args)
    assert (OM.overscale_matmul.launches, AB.abft_matmul.launches) == before


def test_other_devices_and_bad_inputs_are_refused():
    a, b, ug, ub = _case(8, 8, 8, seed=1)
    args = [_t(a), _t(b), _t(ug), _t(ub),
            OM.bit_probs_to_cdf(np.zeros(32), "cpu")]
    meta = [x.to("meta") for x in args]
    with pytest.raises(ValueError):
        OM.overscale_matmul(*meta)
    with pytest.raises(ValueError):
        AB.abft_matmul(*meta)
    assert OM.check_inputs(*args) == (8, 8, 8)
    bad = {0: args[0].to(torch.int32), 1: args[1][:4],
           2: args[2].to(torch.int64), 3: args[3].t(), 4: args[4][:32]}
    for i, x in bad.items():
        with pytest.raises(ValueError):
            OM.check_inputs(*(x if j == i else y for j, y in enumerate(args)))


# the kernel's plan: (M, K, N) -> (tile, splits, A's and B's load widths)
PLANS = {
    # llama3.2-1b's MLP products at 4096 and 48 tokens (the §V path)
    (4096, 2048, 8192): ("wide", 1, 16, 16),
    (4096, 8192, 2048): ("wide", 1, 16, 16),
    (48, 2048, 8192): ("short", 2, 16, 16),
    (48, 8192, 2048): ("short", 8, 16, 16),
    (16, 8192, 64): ("short", 128, 16, 16),
    # LeNet at 1024 images (the over-scaling path)
    (262144, 9, 8): ("n8", 1, 1, 8),
    (65536, 72, 16): ("n16", 1, 8, 16),
    (1024, 256, 10): ("n16", 4, 16, 1),
    # edges and the wrap cases
    (1, 1, 1): ("n8", 1, 1, 1),
    (65, 33, 127): ("wide", 1, 1, 1),
    (8, 1 << 17, 8): ("n8", 128, 16, 8),
    (16, 1 << 18, 16): ("n16", 128, 16, 16),
}


@pytest.mark.parametrize("shape", list(PLANS))
def test_kernel_plan_names_the_tile_split_and_load_widths(shape):
    M, K, N = shape
    p = OM.plan(M, K, N)
    assert (p.tile, p.splits, p.a_width, p.b_width) == PLANS[shape]
    BM, BN = OM.TILES[p.tile]
    kt = max(1, -(-K // OM.BK))
    # every split has work, the splits cover K, and a split-K launch does
    # not outnumber the SMs
    assert (p.splits - 1) * p.per < kt <= p.splits * p.per
    tiles = -(-M // BM) * -(-N // BN)
    assert p.splits == 1 or tiles * p.splits <= OM.SMS
    # an operand that is not aligned to the width loads narrower
    if p.a_width > 1:
        assert OM.plan(M, K, N, a_align=p.a_width // 2).a_width < p.a_width
    if p.b_width > 1:
        assert OM.plan(M, K, N, b_align=2).b_width == 1
        assert p.b_width <= BN and N % p.b_width == 0
