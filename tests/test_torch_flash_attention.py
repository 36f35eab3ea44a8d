"""The port's flash attention (plain version, on the CPU) against the JAX
package's Pallas kernel in interpret mode (``ops.flash_attention_bh``, equal
heads, S a multiple of its blocks) and its oracle
(``repro.kernels.ref.flash_attention_ref``, per (b, h), with the GQA
mapping kv head = h // (H / Hkv) and any S).

Tolerances: 1e-5 in float32, 5e-2 in bfloat16 (the reference's, as in
``tests/test_kernels.py``).
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
    with pytest.raises(ValueError, match="CPU or CUDA"):
        FA.flash_attention(q.to("meta"), k, v)

