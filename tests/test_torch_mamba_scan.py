"""The port's Mamba2 SSD scan (``repro_torch.kernels.mamba_scan``) on the CPU
against the JAX package: the TPU kernel through ``ops.mamba_scan_b`` (run in
interpret mode, as ``tests/test_kernels.py`` runs it), its oracle
``ref.mamba_scan_ref`` (the model's ``ssd_chunked``, y and final state), and
the step-by-step recurrence of ``tests/test_kernels.py``.

On the CPU ``ops.mamba_scan_b`` runs the plain version, which repeats the
Hopper kernel's order of sums. Float32 tolerance: the reference's own
kernel-vs-oracle bound, 2e-4 (``tests/test_kernels.py``); measured here the
plain version stays within 2e-5 of every JAX form at these shapes, so the
tests hold it to 2e-5, and its y to the JAX kernel's at 2e-4 as the
reference holds its kernel.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import ssm as jssm
from repro_torch.kernels import mamba_scan as MS
from repro_torch.kernels import ops
from repro_torch.models import ssm
from test_torch_gpu import SCAN_SHAPES as CARD_SHAPES

TOL = 2e-5
REF_TOL = 2e-4
SHAPES = [(128, 4, 16, 32, 32), (256, 8, 32, 64, 64), (64, 2, 8, 16, 64)]
# (b, S, H, P, G, N, chunk) the kernel runs at: chip_smoke.py phase 9 and
# the card tests
KERNEL_SHAPES = sorted({sh for _, sh in chip_smoke.scan_cases()}
                       | set(CARD_SHAPES))


def _inputs(b, S, H, P, N, seed=0, G=None):
    """numpy inputs with the reference test's scales: x 0.5 N(0,1), dt
    softplus(N(0,1)), A = -exp(0.3 N(0,1)), B and C 0.3 N(0,1)."""
    rng = np.random.default_rng(seed)
    G = H if G is None else G
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    xh = 0.5 * f(b, S, H, P)
    dt = np.log1p(np.exp(f(b, S, H))).astype(np.float32)
    A = -np.exp(0.3 * f(H)).astype(np.float32)
    B = 0.3 * f(b, S, G, N)
    C = 0.3 * f(b, S, G, N)
    return xh, dt, A, B, C


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _differs(name, a, b) -> str:
    """A failure message: how many entries of a and b differ, the first
    differing index and both values there."""
    ne = (a != b).nonzero()
    if not len(ne):
        return (f"{name}: torch.equal is False with no differing entry "
                f"({a.dtype} {tuple(a.shape)} vs {b.dtype} {tuple(b.shape)})")
    i = tuple(ne[0].tolist())
    return (f"{name}: {len(ne)} of {a.numel()} entries differ, the first at "
            f"{i}: {a[i].item()!r} vs {b[i].item()!r}")


@pytest.mark.parametrize("S,H,P,N,chunk", SHAPES)
def test_matches_the_jax_kernel_and_oracle(S, H, P, N, chunk):
    xh, dt, A, B, C = _inputs(2, S, H, P, N, seed=S + N)
    y, state = ops.mamba_scan_b(*_t(xh, dt, A, B, C), chunk=chunk)
    y_plain, s_plain = MS.mamba_scan_ref(*_t(xh, dt, A, B, C), chunk=chunk)
    assert torch.equal(y, y_plain), _differs("y", y, y_plain)
    assert torch.equal(state, s_plain), _differs("state", state, s_plain)
    assert y.shape == xh.shape and state.shape == (2, H, P, N)
    y_k = jops.mamba_scan_b(*(jnp.asarray(a) for a in (xh, dt, A, B, C)),
                            chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_k), rtol=REF_TOL,
                               atol=REF_TOL)
    y_r, s_r = jref.mamba_scan_ref(*(jnp.asarray(a)
                                     for a in (xh, dt, A, B, C)), chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(s_r), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("S,H,P,N,chunk", SHAPES)
def test_ssd_chunked_matches_the_reference(S, H, P, N, chunk):
    """The port's ``ssd_chunked`` (the reference's form) against the
    reference's, and against the kernel-order plain version."""
    xh, dt, A, B, C = _inputs(2, S, H, P, N, seed=S)
    y, s = ssm.ssd_chunked(*_t(xh, dt, A, B, C), chunk)
    y_r, s_r = jssm.ssd_chunked(*(jnp.asarray(a) for a in (xh, dt, A, B, C)),
                                chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_r), rtol=TOL, atol=TOL)
    y_p, s_p = MS.mamba_scan_ref(*_t(xh, dt, A, B, C), chunk=chunk)
    np.testing.assert_allclose(y_p.numpy(), y.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(s_p.numpy(), s.numpy(), rtol=TOL, atol=TOL)


def test_matches_sequential_recurrence():
    """Chunked scan == the step-by-step recurrent ground truth, y and the
    final state (``tests/test_kernels.py``'s oracle, at b = 1)."""
    S, H, P, N = 32, 2, 4, 8
    xh, dt, A, B, C = _inputs(1, S, H, P, N, seed=21)
    y, state = ops.mamba_scan_b(*_t(xh, dt, A, B, C), chunk=8)
    s = np.zeros((H, P, N), np.float32)
    ys = []
    for t in range(S):
        dA = np.exp(dt[0, t] * A)
        s = s * dA[:, None, None] + np.einsum(
            "h,hp,hn->hpn", dt[0, t], xh[0, t], B[0, t])
        ys.append(np.einsum("hpn,hn->hp", s, C[0, t]))
    np.testing.assert_allclose(y[0].numpy(), np.stack(ys), rtol=REF_TOL,
                               atol=REF_TOL)
    np.testing.assert_allclose(state[0].numpy(), s, rtol=REF_TOL,
                               atol=REF_TOL)


def test_groups_read_inside_equal_repeated_heads():
    """B and C as (b, S, G, N): head h reads group h // (H / G), the same
    function as the reference's repeat over heads."""
    xh, dt, A, B, C = _inputs(2, 64, 8, 16, 32, seed=3, G=2)
    y, s = MS.mamba_scan_ref(*_t(xh, dt, A, B, C), chunk=32)
    rep = lambda a: np.repeat(a, 4, axis=2)
    y_h, s_h = MS.mamba_scan_ref(*_t(xh, dt, A, rep(B), rep(C)), chunk=32)
    assert torch.equal(y, y_h) and torch.equal(s, s_h)
    with pytest.raises(ValueError, match="group"):
        MS.mamba_scan_ref(*_t(xh, dt, A, B[:, :, :1].repeat(3, 2),
                              C[:, :, :1].repeat(3, 2)), chunk=32)


def test_bf16_inputs_give_bf16_y_and_float32_state():
    xh, dt, A, B, C = _inputs(1, 64, 4, 16, 16, seed=5)
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (xh, dt, B, C)]
    y, s = ops.mamba_scan_b(bf[0], bf[1], torch.from_numpy(A), bf[2], bf[3],
                            chunk=32)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    y32, s32 = MS.mamba_scan_ref(*[t.float() for t in bf[:2]],
                                 torch.from_numpy(A),
                                 *[t.float() for t in bf[2:]], chunk=32)
    assert torch.equal(y, y32.to(torch.bfloat16)) and torch.equal(s, s32)


@pytest.mark.parametrize("S,chunk", [(40, 32), (96, 64)])
def test_length_not_a_multiple_of_the_chunk_raises(S, chunk):
    """S > chunk and S % chunk != 0: the TPU kernel's assert and the
    reference's reshape fail; the port raises ValueError."""
    xh, dt, A, B, C = _inputs(1, S, 2, 4, 8)
    with pytest.raises(ValueError, match="ssm_chunk"):
        ops.mamba_scan_b(*_t(xh, dt, A, B, C), chunk=chunk)
    with pytest.raises(TypeError, match="reshape"):
        jssm.ssd_chunked(*(jnp.asarray(a) for a in (xh, dt, A, B, C)), chunk)
    with pytest.raises(AssertionError):
        jax.block_until_ready(jops.mamba_scan_b(
            *(jnp.asarray(a) for a in (xh, dt, A, B, C)), chunk=chunk))
    # a length at most the chunk, or a multiple of it, is taken
    assert MS.chunk_len(S, S) == S and MS.chunk_len(2 * chunk, chunk) == chunk


def test_check_inputs_refuses_what_the_kernel_does_not_take():
    xh, dt, A, B, C = _t(*_inputs(1, 64, 4, 16, 32))
    b, S, H, P, G, N, Q = MS.check_inputs(xh, dt, A, B, C, 32)
    assert (b, S, H, P, G, N, Q) == (1, 64, 4, 16, 4, 32, 32)
    with pytest.raises(ValueError, match="float32"):
        MS.check_inputs(xh, dt, A.double(), B, C, 32)
    with pytest.raises(ValueError, match="contiguous"):
        MS.check_inputs(xh, dt, A, torch.cat([B, B], -1)[..., ::2], C, 32)
    with pytest.raises(ValueError, match="state"):
        big = torch.zeros((1, 64, 4, 256))
        MS.check_inputs(xh, dt, A, big, big, 32)
    # a meta xh (the dry run) takes meta inputs only
    with pytest.raises(ValueError, match="dt is on cpu, xh on meta"):
        MS.mamba_scan(xh.to("meta"), dt, A, B, C, chunk=32)


@pytest.mark.parametrize("b,S,H,P,G,N,chunk", KERNEL_SHAPES)
def test_launch_plan(b, S, H, P, G, N, chunk):
    """The two launches of a call at every shape the kernel runs at: each
    block's shared memory within what its launch may take, C B^T's scratch
    b G chunks Q Q float32, the grids, and a group count that does not
    divide the heads refused."""
    meta = lambda *shape: torch.empty(shape, device="meta")
    args = (meta(b, S, H, P), meta(b, S, H), meta(H), meta(b, S, G, N),
            meta(b, S, G, N))
    Q = MS.chunk_len(S, chunk)
    assert MS.check_inputs(*args, chunk) == (b, S, H, P, G, N, Q)
    plan = MS.plan(b, S, H, P, G, N, Q)
    # the C B^T launch takes no more than the 48 KB any launch may take
    assert plan.gram_smem <= 48 * 1024
    assert plan.scan_smem <= MS.SMEM_LIMIT
    assert plan.scratch_bytes == b * G * (S // Q) * Q * Q * 4
    tiles = -(-Q // MS.GRAM_TILE)
    assert plan.gram_grid == (tiles * (tiles + 1) // 2, S // Q, b * G)
    assert plan.scan_grid == (-(-P // MS.P_TILE), H, b)
    for bad in (H + 1, 0):
        with pytest.raises(ValueError, match="group"):
            MS.plan(b, S, H, P, bad, N, Q)
