"""The port's paged attention (plain version, on the CPU) against the JAX
package's Pallas kernel in interpret mode and its oracle
(``repro.kernels.ref.paged_attention_ref``).

Tolerances are the reference's own (``tests/test_kernels.py``): 1e-5 in
float32, 5e-2 with bfloat16 pools; a row disabled with ``pos = -1`` is
exactly zero on both sides. The serving tier's extend form, a (B, S) chunk
flattened to B * S rows, is held against a loop over single tokens; the
chunk form (S rows per slot on the slot's table) against the rows it
flattens to, and against the reference's oracle. The decode's split-K
arithmetic (splits of 16 table entries, partials folded in order) is held
to the reference on tables of several splits.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as kref
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as PA
from repro_torch.models.attention import _sdpa

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _paged_case(B=3, H=4, Hkv=2, D=16, ps=8, npages=4, seed=0,
                pos=(29, 7, -1)):
    """test_kernels.py's scattered layout: pages permuted across the pool,
    one slot fully disabled (pos = -1), one mid-page (pos = 7), one
    mid-pool; the last page of the pool is the null page."""
    rng = np.random.default_rng(seed)
    P = B * npages
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((P + 1, ps, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((P + 1, ps, Hkv, D)).astype(np.float32)
    ids = np.full((P + 1, ps), -1, np.int32)
    perm = rng.permutation(P)
    bt = np.full((B, npages), P, np.int32)
    pos = np.array(pos, np.int32)[:B]
    for b in range(B):
        if pos[b] < 0:
            continue
        for j in range(pos[b] // ps + 1):
            pg = perm[b * npages + j]
            bt[b, j] = pg
            span = np.arange(j * ps, (j + 1) * ps)
            ids[pg] = np.where(span <= pos[b], span, -1)
    return q, k, v, ids, bt, pos


def _jax(dtype, q, k, v, ids, bt, pos, window, oracle=False):
    fn = kref.paged_attention_ref if oracle else jops.paged_attention_decode
    dt = JDT[dtype]
    out = fn(jnp.asarray(q, dt), jnp.asarray(k, dt), jnp.asarray(v, dt),
             jnp.asarray(ids), jnp.asarray(bt), jnp.asarray(pos),
             window=window)
    return np.asarray(out, np.float32)


def _port(dtype, q, k, v, ids, bt, pos, window):
    dt = TDT[dtype]
    out = ops.paged_attention_decode(
        torch.from_numpy(q).to(dt), torch.from_numpy(k).to(dt),
        torch.from_numpy(v).to(dt), torch.from_numpy(ids),
        torch.from_numpy(bt), torch.from_numpy(pos), window=window)
    assert out.dtype == dt and out.shape == q.shape
    return out.float().numpy()


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 5e-2)])
@pytest.mark.parametrize("window", [0, 12])
def test_scattered_pages_match_reference(dtype, tol, window):
    case = _paged_case()
    before = PA.paged_attention.launches
    got = _port(dtype, *case, window)
    assert PA.paged_attention.launches == before  # the CPU runs no kernel
    for oracle in (False, True):
        want = _jax(dtype, *case, window, oracle=oracle)
        np.testing.assert_allclose(got[:2], want[:2], rtol=tol, atol=tol)
        assert (want[2] == 0.0).all()
    # pos = -1 disables the row: exact zeros, not mean(v)
    assert (got[2] == 0.0).all()


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 5e-2)])
def test_flattened_extend_matches_per_token_loop(dtype, tol):
    """A (B, S) extend flattened to B * S rows (each slot's table row
    repeated S times, each row at its own position) equals one query at a
    time through the reference's oracle, and the reference's kernel on the
    same flattened rows."""
    q1, k, v, ids, bt, _ = _paged_case(seed=3)
    rng = np.random.default_rng(4)
    B, S = 2, 5
    start = np.array([25, 3], np.int32)
    q = rng.standard_normal((B, S) + q1.shape[1:]).astype(np.float32)
    positions = start[:, None] + np.arange(S, dtype=np.int32)[None]
    rows_q = q.reshape(B * S, *q.shape[2:])
    rows_bt = np.repeat(bt[:B], S, axis=0)
    rows_pos = positions.reshape(-1)
    got = _port(dtype, rows_q, k, v, ids, rows_bt, rows_pos, 0)
    loop = np.stack([
        _jax(dtype, rows_q[r:r + 1], k, v, ids, rows_bt[r:r + 1],
             rows_pos[r:r + 1], 0, oracle=True)[0]
        for r in range(B * S)])
    np.testing.assert_allclose(got, loop, rtol=tol, atol=tol)
    kern = _jax(dtype, rows_q, k, v, ids, rows_bt, rows_pos, 0)
    np.testing.assert_allclose(got, kern, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 5e-2)])
@pytest.mark.parametrize("window", [0, 48])
def test_split_decode_matches_reference(dtype, tol, window):
    """Tables of 40 pages of 4 entries (3 splits of 16): a row that reaches
    into the third split, one whose later splits see nothing, one disabled
    (pos = -1, exact zeros): the split-K decode within the reference's
    tolerance of the Pallas kernel and of its oracle."""
    case = _paged_case(ps=4, npages=40, pos=(150, 20, -1), seed=6)
    assert -(-case[4].shape[1] // PA.SPLIT) == 3
    got = _port(dtype, *case, window)
    for oracle in (False, True):
        want = _jax(dtype, *case, window, oracle=oracle)
        np.testing.assert_allclose(got[:2], want[:2], rtol=tol, atol=tol)
    assert (got[2] == 0.0).all()


def _chunk_case(seed=7, S=6):
    """Chunks of S rows on three slots of ``_paged_case``'s pool: slot 0 at
    positions 24.. with its last two rows padded (their entries -1 in the
    cache, their positions kept), slot 1 at positions out of order, slot 2
    with a row disabled (pos = -1)."""
    q1, k, v, ids, bt, _ = _paged_case(seed=seed, pos=(31, 31, 31))
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((3, S) + q1.shape[1:]).astype(np.float32)
    pos = np.stack([24 + np.arange(S), rng.permutation(S) + 5,
                    np.arange(S) + 10]).astype(np.int32)
    pos[2, 2] = -1
    ids[bt[0]] = np.where(ids[bt[0]] > 24 + S - 3, -1, ids[bt[0]])
    return q, k, v, ids, bt, pos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 48])
@pytest.mark.parametrize("S", [6, 20])
def test_chunk_form_equals_rows(dtype, window, S):
    """The chunk form is the row form over the flattened rows: bit for bit
    in float32 and for chunks of at most ``CHUNK_ROWS`` rows (all take the
    decode's arithmetic, so a speculative verify scores as greedy decoding
    does); a bf16 chunk of more rows takes the tensor-core extend's tiles
    (the weights as two bf16 halves before P V, the tensor cores' sums) and
    stays within the reference's bf16 tolerance of its rows."""
    q, k, v, ids, bt, pos = _chunk_case(S=S)
    dt = TDT[dtype]
    B, S = pos.shape
    args = (torch.from_numpy(k).to(dt), torch.from_numpy(v).to(dt),
            torch.from_numpy(ids))
    for s in (1, S):
        qc = torch.from_numpy(q[:, :s].copy()).to(dt)
        pc = torch.from_numpy(pos[:, :s].copy())
        chunk = ops.paged_attention_decode(qc, *args, torch.from_numpy(bt),
                                           pc, window=window)
        rows = ops.paged_attention_decode(
            qc.reshape(B * s, *qc.shape[2:]), *args,
            torch.from_numpy(np.repeat(bt, s, axis=0)), pc.reshape(-1),
            window=window)
        assert chunk.shape == qc.shape and chunk.dtype == dt
        flat = chunk.reshape(rows.shape)
        if s <= PA.CHUNK_ROWS or dtype == "float32":
            assert torch.equal(flat, rows)
        else:
            np.testing.assert_allclose(flat.float().numpy(),
                                       rows.float().numpy(), rtol=5e-2,
                                       atol=5e-2)
    assert (chunk[2, 2] == 0).all()


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 5e-2)])
@pytest.mark.parametrize("S", [5, 20])
def test_chunk_form_matches_reference(dtype, tol, S):
    """Each row of a chunk against the reference's oracle on its own (one
    query, its slot's table, its position) and the reference's kernel on
    the flattened rows: the split-K rows (S <= 16) and, in bf16, the
    tensor-core extend (S = 20)."""
    q, k, v, ids, bt, pos = _chunk_case(seed=8, S=S)
    B, S = pos.shape
    dt = TDT[dtype]
    got = ops.paged_attention_decode(
        torch.from_numpy(q).to(dt), torch.from_numpy(k).to(dt),
        torch.from_numpy(v).to(dt), torch.from_numpy(ids),
        torch.from_numpy(bt), torch.from_numpy(pos)).float().numpy()
    rows_q = q.reshape(B * S, *q.shape[2:])
    rows_bt = np.repeat(bt, S, axis=0)
    rows_pos = pos.reshape(-1)
    loop = np.stack([
        _jax(dtype, rows_q[r:r + 1], k, v, ids, rows_bt[r:r + 1],
             rows_pos[r:r + 1], 0, oracle=True)[0] for r in range(B * S)])
    np.testing.assert_allclose(got.reshape(loop.shape), loop, rtol=tol,
                               atol=tol)
    kern = _jax(dtype, rows_q, k, v, ids, rows_bt, rows_pos, 0)
    np.testing.assert_allclose(got.reshape(kern.shape), kern, rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 4, 256])
def test_shared_memory_does_not_grow_with_the_table(dtype, S):
    """A block's shared memory depends on the page and the head, not on
    the table: the wrapper takes a table of 4096 pages of 16 (65,536
    positions) at head_dim 128, decode, a speculative chunk and a prefill
    chunk alike, and each path's block stays under the card's limit."""
    B, H, Hkv, D, ps, n = 2, 32, 8, 128, 16, 4096
    q = torch.zeros((B, S, H, D), dtype=dtype)
    pool = torch.zeros((9, ps, Hkv, D), dtype=dtype)
    ids = torch.full((9, ps), -1, dtype=torch.int32)
    bt = torch.full((B, n), 8, dtype=torch.int32)
    pos = torch.zeros((B, S), dtype=torch.int32)
    assert PA.check_inputs(q, pool, pool, ids, bt, pos)[-1] == n
    elem = q.element_size()
    assert PA.smem_bytes(S, H // Hkv, D, ps, elem) <= PA.SMEM_LIMIT
    assert PA._route(S, dtype) == ("split" if S <= PA.CHUNK_ROWS else
                                   "mma" if dtype == torch.bfloat16 else
                                   "fold")


def test_plain_is_sdpa_at_page_eq_maxlen():
    """With page_size == max_len and an identity block table the plain
    version is the model's masked ``_sdpa`` up to float32 rounding (the
    port's counterpart of the reference's anchor; the plain version sums in
    the kernel's order)."""
    rng = np.random.default_rng(1)
    B, H, Hkv, D, T = 3, 4, 2, 16, 32
    q = torch.from_numpy(rng.standard_normal((B, H, D)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((B, T, Hkv, D)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((B, T, Hkv, D)).astype(
        np.float32))
    pos = torch.tensor([29, 7, 0], dtype=torch.int32)
    span = torch.arange(T)[None, :]
    ids = torch.where(span <= pos[:, None], span, -1).to(torch.int32)
    bt = torch.arange(B, dtype=torch.int32)[:, None]
    got = PA.paged_attention_ref(q, k, v, ids, bt, pos)
    mask = (ids >= 0) & (ids <= pos[:, None])
    dense = _sdpa(q[:, None], k, v, mask[:, None, None, None, :])[:, 0]
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_warp_sum_is_the_butterfly():
    """The plain version sums 32 lanes as the kernel's xor shuffles do,
    simulated lane by lane in float32 (every lane ends equal)."""
    rng = np.random.default_rng(2)
    for _ in range(20):
        vals = (rng.standard_normal(32) * 10.0 ** rng.integers(-3, 4, 32)
                ).astype(np.float32)
        lanes = list(vals)
        for o in (16, 8, 4, 2, 1):
            lanes = [np.float32(lanes[i] + lanes[i ^ o]) for i in range(32)]
        assert len(set(lanes)) == 1
        got = PA.warp_sum(torch.from_numpy(vals)[None])[0]
        assert got.item() == lanes[0]


def test_wrapper_refuses_other_devices():
    q, k, v, ids, bt, pos = (torch.from_numpy(x) for x in _paged_case())
    with pytest.raises(ValueError, match="CPU or CUDA"):
        PA.paged_attention(q.to("meta"), k, v, ids, bt, pos)
