"""The §V ABFT tier of the port against the JAX package.

``AbftMatmul`` on the reference's planes (replayed through the ``planes``
hook) must give the reference's ledger exactly: every count is decided by
int32 arithmetic. That includes the heavy case, whose ledger shows the
reference's aliasing fault in ``detect_and_correct`` (a unique
``dr[i] == dc[j]`` pairing made by two flips of equal delta "repairs" a
healthy cell): the port reproduces it. ``detect_and_correct`` gives equal
outputs on the reference's own cases; the outputs of ``AbftMatmul`` agree
within 1e-6 relative (the reference clips at numpy's float64 quantile, the
port at jnp's float32 one).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.abft_matmul import checksum_refs as jchecksum_refs
from repro.tolerance import AbftMatmul as JAbftMatmul
from repro.tolerance import detect_and_correct as jdetect
from repro.tolerance import topk_agreement as jtopk
from repro_torch import tolerance as TT
from repro_torch.kernels import abft_matmul as AB


def jax_planes(key):
    """The reference's planes of its n-th call (``fold_in(key, n)``)."""
    def planes(n, shape):
        k1, k2 = jax.random.split(jax.random.fold_in(key, n))
        return tuple(torch.from_numpy(np.array(
            np.asarray(jax.random.bits(k, shape, jnp.uint32)).view(np.int32)))
            for k in (k1, k2))
    return planes


def _tail(lo, p):
    probs = np.zeros(32)
    probs[lo:] = p
    return probs


# tests/test_tolerance.py's three AbftMatmul cases: (probs, key, data seed,
# (M, K, N)); the heavy one is where the reference's ledger breaks its own
# invariant
CASES = {
    "sparse": (_tail(20, 0.0008 / 12.0), 7, 1, (48, 64, 40)),
    "heavy": (_tail(26, 0.02 / 6.0), 7, 1, (48, 64, 40)),
    "zero": (np.zeros(32), 0, 4, (32, 48, 24)),
}
LEDGER = ("checked", "injected", "detected", "corrected", "escaped")


@pytest.mark.parametrize("case", sorted(CASES))
def test_ledger_equals_reference(case):
    probs, key_seed, data_seed, (M, K, N) = CASES[case]
    key = jax.random.PRNGKey(key_seed)
    rng = np.random.default_rng(data_seed)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal((K, N)).astype(np.float32)
    ref = JAbftMatmul(probs, key)
    want = np.asarray(ref(a, b))
    mm = TT.AbftMatmul(probs, seed=0, planes=jax_planes(key), device="cpu")
    got = mm(torch.from_numpy(a), torch.from_numpy(b))
    assert [getattr(mm.counters, k) for k in LEDGER] == \
        [getattr(ref.counters, k) for k in LEDGER]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    if case == "heavy":
        c = mm.counters
        assert (c.injected, c.detected, c.corrected, c.escaped) == \
            (38, 28, 2, 38)
    if case == "zero":
        assert mm.counters.injected == mm.counters.escaped == 0


def test_ledger_accumulates_over_calls():
    probs, key_seed, _, _ = CASES["sparse"]
    key = jax.random.PRNGKey(key_seed)
    ref = JAbftMatmul(probs, key)
    mm = TT.AbftMatmul(probs, seed=0, planes=jax_planes(key), device="cpu")
    rng = np.random.default_rng(11)
    for M, K, N in [(48, 64, 40), (16, 128, 96), (48, 64, 40)]:
        a = rng.standard_normal((M, K)).astype(np.float32)
        b = rng.standard_normal((K, N)).astype(np.float32)
        ref(a, b)
        mm(torch.from_numpy(a), torch.from_numpy(b))
    assert [getattr(mm.counters, k) for k in LEDGER] == \
        [getattr(ref.counters, k) for k in LEDGER]
    assert mm.counters.detect_rate == ref.counters.detect_rate
    assert mm.counters.escape_rate == ref.counters.escape_rate


def test_plain_and_seeded_planes_give_the_same_ledger():
    """``use_kernel=False`` is the plain version; on the CPU the wrapper
    runs it too, so the two streams agree call for call."""
    probs = _tail(26, 0.02 / 6.0)
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((48, 64)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((64, 40)).astype(np.float32))
    m1 = TT.AbftMatmul(probs, seed=5, device="cpu")
    m2 = TT.AbftMatmul(probs, seed=5, use_kernel=False, device="cpu")
    assert torch.equal(m1(a, b), m2(a, b))
    assert m1.counters == m2.counters
    assert m1.counters.injected > 5


def _clean(m=16, k=12, n=20, seed=2):
    rng = np.random.default_rng(seed)
    a = rng.integers(-4, 4, (m, k)).astype(np.int8)
    b = rng.integers(-4, 4, (k, n)).astype(np.int8)
    return a, b, a.astype(np.int32) @ b.astype(np.int32)


# tests/test_tolerance.py::TestDetectAndCorrect's corruptions: (i, j, delta)
CORRUPTIONS = {
    "single": [(3, 5, 1 << 20)],
    "distinct_double": [(1, 2, 1 << 18), (7, 9, -(1 << 22))],
    "aliased_row": [(3, 5, 1 << 20), (3, 9, 1 << 20)],
    "ambiguous": [(2, 4, 1 << 19), (6, 8, 1 << 19)],
    "msb_wrap": [(0, 0, -(1 << 31)), (5, 7, 1 << 30)],
    "clean": [],
}


@pytest.mark.parametrize("name", sorted(CORRUPTIONS))
def test_detect_and_correct_equals_reference(name):
    a, b, clean = _clean()
    bad = clean.astype(np.int64)
    for i, j, d in CORRUPTIONS[name]:
        bad[i, j] += d
    bad = bad.astype(np.int32)
    rs = bad.sum(axis=1, dtype=np.int64).astype(np.int32)
    cs = bad.sum(axis=0, dtype=np.int64).astype(np.int32)
    row_ref, col_ref = jchecksum_refs(a, b)
    want = jdetect(bad, rs, cs, row_ref, col_ref)
    t = lambda x: torch.from_numpy(np.array(x, np.int32))
    got = TT.detect_and_correct(t(bad), t(rs), t(cs), t(row_ref),
                                t(col_ref))
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    assert got[1:] == want[1:]
    rr, cr = AB.checksum_refs(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(rr.numpy(), np.asarray(row_ref))
    np.testing.assert_array_equal(cr.numpy(), np.asarray(col_ref))


@pytest.mark.parametrize("k", [1, 3])
def test_topk_agreement_equals_reference(k):
    rng = np.random.default_rng(k)
    ref = rng.standard_normal((2, 24, 50)).astype(np.float32)
    noisy = ref + 0.5 * rng.standard_normal(ref.shape).astype(np.float32)
    assert TT.topk_agreement(torch.from_numpy(noisy), torch.from_numpy(ref),
                             k) == pytest.approx(jtopk(noisy, ref, k),
                                                 abs=1e-12)
    assert TT.topk_agreement(ref, ref, k) == 1.0


def test_abft_matmul_needs_a_card_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.AbftMatmul(np.zeros(32), seed=0)
