"""The port's flash attention (plain version, on the CPU) against the JAX
package's Pallas kernel in interpret mode (``ops.flash_attention_bh``, equal
heads, S a multiple of its blocks) and its oracle
(``repro.kernels.ref.flash_attention_ref``, per (b, h), with the GQA
mapping kv head = h // (H / Hkv) and any S).

Tolerances: 1e-5 in float32, 5e-2 in bfloat16 (the reference's, as in
``tests/test_kernels.py``). The bf16 plain version follows the tensor-core
kernel: its sums over a tile in the kernel's quad order, its products
summed as the H100's tensor cores sum one m16n8k16 step
(``tensor_core_mma``, held here to the model written out in exact
arithmetic).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as kref
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 1e-5, "bfloat16": 5e-2}


def _qkv(B, S, T, H, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, T, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, T, Hkv, D)).astype(np.float32))


def _port(dtype, q, k, v, causal):
    dt = TDT[dtype]
    out = ops.flash_attention_bh(torch.from_numpy(q).to(dt),
                                 torch.from_numpy(k).to(dt),
                                 torch.from_numpy(v).to(dt), causal=causal)
    assert out.dtype == dt and out.shape == q.shape
    return out.float().numpy()


def _oracle(dtype, q, k, v, causal):
    """The reference's single-head oracle over (b, h), kv head h // G."""
    dt = JDT[dtype]
    B, S, H, D = q.shape
    G = H // k.shape[2]
    out = np.zeros(q.shape, np.float32)
    for b in range(B):
        for h in range(H):
            o = kref.flash_attention_ref(
                jnp.asarray(q[b, :, h], dt), jnp.asarray(k[b, :, h // G], dt),
                jnp.asarray(v[b, :, h // G], dt), causal=causal)
            out[b, :, h] = np.asarray(o, np.float32)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_matches_pallas_kernel_and_oracle(dtype, causal):
    q, k, v = _qkv(2, 128, 128, 2, 2, 32, seed=0)
    got = _port(dtype, q, k, v, causal)
    dt = JDT[dtype]
    kern = np.asarray(jops.flash_attention_bh(
        jnp.asarray(q, dt), jnp.asarray(k, dt), jnp.asarray(v, dt),
        causal=causal), np.float32)
    tol = TOL[dtype]
    np.testing.assert_allclose(got, kern, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, _oracle(dtype, q, k, v, causal),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [37, 100])
def test_gqa_and_ragged_length(dtype, causal, S):
    """GQA (4 query heads on 2 kv heads) at lengths that are not a multiple
    of the TPU kernel's 128-row blocks."""
    q, k, v = _qkv(2, S, S, 4, 2, 16, seed=S)
    np.testing.assert_allclose(_port(dtype, q, k, v, causal),
                               _oracle(dtype, q, k, v, causal),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_plain_is_sdpa_under_the_causal_mask():
    """In float32 the plain version is the model's causal ``_sdpa`` up to
    rounding (the model's prefill used ``_sdpa`` in the reference)."""
    from repro_torch.models.attention import _sdpa, causal_mask
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 50, 50, 4, 2, 16, 5))
    want = _sdpa(q, k, v, causal_mask(50, 50, 0))
    np.testing.assert_allclose(FA.flash_attention_ref(q, k, v).numpy(),
                               want.numpy(), rtol=1e-5, atol=1e-5)


def test_cpu_runs_no_kernel_and_other_devices_raise():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 8, 8, 2, 1, 16, 7))
    before = FA.flash_attention.launches
    FA.flash_attention(q, k, v)
    assert FA.flash_attention.launches == before
    # a meta q (the dry run) takes meta k and v: a CPU k raises
    with pytest.raises(ValueError, match="k is on cpu, q on meta"):
        FA.flash_attention(q.to("meta"), k, v)



def test_quad_sum_is_the_kernel_order():
    """A tile's 64 weights summed as the kernel sums them, simulated lane by
    lane in float32: lane t of the quad adds keys 8 j + 2 t, 8 j + 2 t + 1
    for j = 0..7, then the quad adds lane t ^ 1, then lane t ^ 2."""
    rng = np.random.default_rng(9)
    for _ in range(20):
        vals = (rng.standard_normal(64) * 10.0 ** rng.integers(-3, 4, 64)
                ).astype(np.float32)
        lanes = [np.float32(0.0)] * 4
        for j in range(8):
            for t in range(4):
                for e in range(2):
                    lanes[t] = np.float32(lanes[t] + vals[8 * j + 2 * t + e])
        for o in (1, 2):
            lanes = [np.float32(lanes[t] + lanes[t ^ o]) for t in range(4)]
        assert len(set(lanes)) == 1
        assert FA.quad_sum(torch.from_numpy(vals)[None])[0].item() == lanes[0]


def _mma_ref(a, b, c, bits=25):
    """One tensor-core step in exact rational arithmetic: the products and
    c aligned to the largest exponent (operand-exponent sums for the
    products), cut toward zero to 2^(emax - bits), summed, the sum cut
    toward zero to float32."""
    from fractions import Fraction
    import math as m
    terms, exps = [], []
    for x, y in zip(a, b):
        if x and y:
            terms.append(Fraction(float(x)) * Fraction(float(y)))
            exps.append(m.frexp(float(x))[1] - 1 + m.frexp(float(y))[1] - 1)
    if c:
        terms.append(Fraction(float(c)))
        exps.append(m.frexp(float(c))[1] - 1)
    if not terms:
        return 0.0
    ulp = Fraction(2) ** (max(exps) - bits)
    total = sum(int(t / ulp) * ulp for t in terms)  # int() cuts toward 0
    r = np.float32(float(total))
    if abs(Fraction(float(r))) > abs(total):
        r = np.nextafter(r, np.float32(0))
    return float(r)


def test_tensor_core_mma_is_the_stated_model():
    """``tensor_core_mma`` against the model written out in exact rational
    arithmetic, on products spread over a wide range of exponents (where
    the cut to 25 bits below the largest drops bits) and signs that
    cancel."""
    rng = np.random.default_rng(11)
    a = torch.from_numpy((rng.standard_normal((6, 16))
                          * 2.0 ** rng.integers(-14, 14, (6, 16))
                          ).astype(np.float32)).bfloat16().float()
    b = torch.from_numpy((rng.standard_normal((16, 8))
                          * 2.0 ** rng.integers(-14, 14, (16, 8))
                          ).astype(np.float32)).bfloat16().float()
    b[8:, 0] = -b[:8, 0]
    a[0, 8:] = a[0, :8]  # row 0, column 0: the products cancel in pairs
    c = torch.from_numpy((rng.standard_normal((6, 8))
                          * 2.0 ** rng.integers(-20, 20, (6, 8))
                          ).astype(np.float32))
    c[1] = 0.0
    got = FA.tensor_core_mma(a, b, c)
    assert got.dtype == torch.float32
    for i in range(6):
        for j in range(8):
            assert got[i, j].item() == _mma_ref(a[i].tolist(),
                                                b[:, j].tolist(),
                                                c[i, j].item()), (i, j)
    # no term cut, no sum cut: the exact sum
    small = torch.ones((1, 16)), torch.full((16, 1), 0.5)
    assert FA.tensor_core_mma(*small, torch.ones((1, 1))).item() == 9.0
    # a zero step leaves the accumulator as it is
    assert torch.equal(FA.tensor_core_mma(torch.zeros((6, 16)), b, c), c)


def test_tensor_core_matmul_chains_steps():
    rng = np.random.default_rng(12)
    a = torch.from_numpy(rng.standard_normal((3, 5, 48)).astype(
        np.float32)).bfloat16().float()
    b = torch.from_numpy(rng.standard_normal((3, 48, 7)).astype(
        np.float32)).bfloat16().float()
    c = torch.zeros((3, 5, 7))
    want = c
    for k0 in (0, 16, 32):
        want = FA.tensor_core_mma(a[..., k0:k0 + 16], b[:, k0:k0 + 16], want)
    assert torch.equal(FA.tensor_core_matmul(a, b, c), want)
    np.testing.assert_allclose(want.numpy(), (a @ b).numpy(), rtol=1e-5,
                               atol=1e-5)
