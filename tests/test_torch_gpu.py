"""The port's Hopper kernels against their plain PyTorch versions, on the card.

Run on a machine with a CUDA card: ``pytest -m gpu tests/test_torch_gpu.py``.
Without one every test here skips (the ``cuda`` fixture decides, at run
time). The stencil kernel and the fused multigrid solve round every
operation as their plain versions do,
the error-injecting int8 matmuls decide every output in integer arithmetic
and the reference's float32 rounding, the attention kernels' plain versions
repeat the kernels' online softmax one operation at a time in the kernels'
order, and the Mamba2 scan's plain version repeats the kernel's order of
sums, so each must agree with its plain version bit for bit; the bf16
tensor-core tiles of flash attention and of the paged extend too, since
their plain versions sum each m16n8k16 step as the card's tensor cores do
(``flash_attention.tensor_core_mma``).
"""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch.core import thermal
from repro_torch.kernels import thermal_stencil as TS

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(m, n, B, device, seed=11):
    g_v, g_lat = thermal.conductances(m, n, thermal.ThermalConfig(theta_ja=12.0))
    rng = np.random.default_rng(seed)
    f32 = dict(dtype=torch.float32, device=device)
    T = torch.tensor(rng.uniform(25, 40, (B, m, n)), **f32)
    P = torch.tensor(rng.uniform(0, 5e-3, (B, m, n)), **f32)
    diag = torch.tensor(thermal._diag_np(np.full((m, n), g_v), g_lat), **f32)
    return T, P, diag, g_lat, g_v * 25.0


@pytest.mark.parametrize("m,n", [(1, 1), (23, 17), (23, 23), (38, 38),
                                 (46, 46), (76, 76), (92, 92), (152, 152),
                                 (256, 256)])
@pytest.mark.parametrize("phase", [None, 0, 1])
@pytest.mark.parametrize("B", [1, 3])
def test_kernel_equals_plain(cuda, m, n, phase, B):
    T, P, diag, g_lat, g_vt = _inputs(m, n, B, cuda)
    before = TS.thermal_stencil.launches
    out = TS.thermal_stencil(T, P, diag, g_lat=g_lat, g_v_tamb=g_vt, iters=5,
                             phase=phase)
    ref = TS.thermal_stencil_ref(T, P, diag, g_lat, g_vt, 5, phase)
    torch.cuda.synchronize()
    resident = TS.is_resident(m, n, phase, cuda)
    assert resident == (m * n < 256 * 256)
    assert TS.thermal_stencil.launches == before + TS.kernel_launches(
        5, phase, resident)
    assert torch.equal(out, ref)


def test_two_dim_call_and_per_element_p(cuda):
    T, P, diag, g_lat, g_vt = _inputs(23, 23, 2, cuda)
    full = TS.thermal_stencil(T, P, diag, g_lat=g_lat, g_v_tamb=g_vt,
                              iters=3, phase=0)
    one = TS.thermal_stencil(T[1], P[1], diag, g_lat=g_lat, g_v_tamb=g_vt,
                             iters=3, phase=0)
    assert torch.equal(full[1], one)


def test_rejects_bad_input(cuda):
    T, P, diag, g_lat, g_vt = _inputs(8, 8, 1, cuda)
    with pytest.raises(ValueError):
        TS.thermal_stencil(T.double(), P, diag, g_lat=g_lat, g_v_tamb=g_vt,
                           iters=1, phase=0)
    with pytest.raises(ValueError):
        TS.thermal_stencil(T, P[:, :4], diag, g_lat=g_lat, g_v_tamb=g_vt,
                           iters=1, phase=0)


def test_solve_kernel_backend_matches_torch_backend(cuda):
    m = n = 92
    rng = np.random.default_rng(3)
    P = rng.uniform(0.0, 5.0, (2, m * n))
    T_k = thermal.solve(P, m, n, [25.0, 60.0],
                        thermal.ThermalConfig(theta_ja=12.0, backend="kernel"),
                        device=cuda)
    T_t = thermal.solve(P, m, n, [25.0, 60.0],
                        thermal.ThermalConfig(theta_ja=12.0, backend="torch"),
                        device=cuda)
    assert torch.equal(T_k, T_t)


# --- the fused multigrid solve -------------------------------------------------

# (m, n, theta_JA): the FPGA paths' grids at their paths' packages
MG_GRIDS = [(92, 92, 12.0), (152, 152, 2.0), (56, 56, 12.0), (69, 69, 12.0)]


def _mg_problem(m, n, theta, B, device, seed=4):
    """(b, plan, kwargs) as ``thermal.solve`` builds them, from random power
    maps (one of them zero) and ambients."""
    tc = thermal.ThermalConfig(theta_ja=theta)
    g_v, g_lat = thermal.conductances(m, n, tc)
    plan = thermal._plan_on(m, n, g_v, g_lat, tc.coarse_cells, device)
    rng = np.random.default_rng(seed)
    P = rng.uniform(0.0, 5.0, (B, m, n))
    P[B // 2] = 0.0
    t_amb = rng.uniform(0.0, 85.0, (B, 1, 1))
    b = torch.tensor(P * 1e-3 + g_v * t_amb, dtype=torch.float32,
                     device=device)
    kw = dict(tol=tc.tol, max_cycles=tc.max_cycles, n_smooth=tc.n_smooth)
    return b, plan, kw


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("B", [1, 86])
@pytest.mark.parametrize("m,n,theta", MG_GRIDS)
def test_fused_solve_equals_plain(cuda, m, n, theta, B, warm):
    from repro_torch.kernels import thermal_mg as MG
    b, plan, kw = _mg_problem(m, n, theta, B, cuda)
    T0 = (torch.full_like(b, 40.0) + b * 1e3) if warm else None
    before = MG.thermal_mg_solve.launches
    T, cycles = MG.thermal_mg_solve(b, T0, plan, **kw)
    assert MG.thermal_mg_solve.launches == before + 1
    ref, ref_cycles = MG.thermal_mg_solve_ref(b, T0, plan, **kw)
    torch.cuda.synchronize()
    assert torch.equal(cycles, ref_cycles)
    assert torch.equal(T, ref)


@pytest.mark.parametrize("max_cycles", [2, 200])
def test_fused_solve_mixed_batch_and_cycle_budget(cuda, max_cycles):
    """A batch of a converged field (0 cycles), a start far from the
    solution and a zero map; with max_cycles 2 and tol 0 every unconverged
    element stops at the budget."""
    from repro_torch.kernels import thermal_mg as MG
    b, plan, kw = _mg_problem(56, 56, 12.0, 3, cuda)
    done, _ = MG.thermal_mg_solve_ref(b[:1], None, plan, **kw)
    T0 = torch.cat([done, torch.full((2, 56, 56), 60.0, device=cuda)])
    kw["max_cycles"] = max_cycles
    if max_cycles == 2:
        kw["tol"] = 0.0
    T, cycles = MG.thermal_mg_solve(b, T0, plan, **kw)
    ref, ref_cycles = MG.thermal_mg_solve_ref(b, T0, plan, **kw)
    torch.cuda.synchronize()
    assert torch.equal(cycles, ref_cycles) and torch.equal(T, ref)
    assert cycles.tolist()[1:] == [2, 2] if max_cycles == 2 else (
        int(cycles[0]) == 0)


def test_path_solve_is_one_launch(cuda):
    """A multigrid solve at a path grid is one fused launch: no stencil
    launch and no host read of a stop test."""
    from repro_torch.kernels import thermal_mg as MG
    P = np.random.default_rng(3).uniform(0.0, 5.0, (4, 92 * 92))
    counts = (MG.thermal_mg_solve.launches, TS.thermal_stencil.launches,
              thermal.solve.host_syncs, thermal.solve.composed)
    thermal.solve(P, 92, 92, [25.0, 40.0, 60.0, 85.0],
                  thermal.ThermalConfig(theta_ja=12.0), device=cuda)
    torch.cuda.synchronize()
    assert (MG.thermal_mg_solve.launches, TS.thermal_stencil.launches,
            thermal.solve.host_syncs, thermal.solve.composed) == (
        counts[0] + 1, counts[1], counts[2], counts[3])


def test_large_grid_takes_the_composition(cuda):
    """256x256 does not fit one CTA: the per-step form with the stencil
    kernel as smoother, one stop-test read per cycle, equal to the plain
    version bit for bit."""
    from repro_torch.kernels import thermal_mg as MG
    P = np.random.default_rng(5).uniform(0.0, 1.0, (256 * 256,))
    tc = thermal.ThermalConfig(theta_ja=2.0)
    counts = (MG.thermal_mg_solve.launches, TS.thermal_stencil.launches,
              thermal.solve.host_syncs, thermal.solve.composed)
    T = thermal.solve(P, 256, 256, 25.0, tc, device=cuda)
    assert MG.thermal_mg_solve.launches == counts[0]
    assert TS.thermal_stencil.launches > counts[1]
    assert thermal.solve.host_syncs > counts[2]
    assert thermal.solve.composed == counts[3] + 1
    plain = thermal.solve(P, 256, 256, 25.0,
                          thermal.ThermalConfig(theta_ja=2.0, backend="torch"),
                          device=cuda)
    assert torch.equal(T, plain)


def test_fused_solve_refuses_bad_input(cuda):
    from repro_torch.kernels import thermal_mg as MG
    b, plan, kw = _mg_problem(56, 56, 12.0, 2, cuda)
    with pytest.raises(ValueError):
        MG.thermal_mg_solve(b.double(), None, plan, **kw)
    with pytest.raises(ValueError):
        MG.thermal_mg_solve(b[:, :, :8].contiguous(), None, plan, **kw)
    with pytest.raises(ValueError):
        MG.thermal_mg_solve(b, b[:1], plan, **kw)
    cpu_plan = thermal._plan_on(56, 56, *thermal.conductances(
        56, 56, thermal.ThermalConfig(theta_ja=12.0)), 512,
        torch.device("cpu"))
    with pytest.raises(ValueError):
        MG.thermal_mg_solve(b, None, cpu_plan, **kw)


# --- the error-injecting int8 matmuls -----------------------------------------

def _mm_inputs(M, K, N, device, seed=5, probs=None):
    from repro_torch.kernels import overscale_matmul as OM
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    a = torch.randint(-128, 128, (M, K), dtype=torch.int8, generator=g,
                      device=device)
    b = torch.randint(-128, 128, (K, N), dtype=torch.int8, generator=g,
                      device=device)
    u_gate, u_bit = OM.random_planes(g, (M, N), device)
    if probs is None:
        probs = np.zeros(32)
        probs[24:] = 0.02
    return a, b, u_gate, u_bit, OM.bit_probs_to_cdf(probs, device)


# LeNet's products at 1024 images, llama3.2-1b's MLP widths at 48 and 4096
# tokens, K split 128 ways, and ragged edges
MM_SHAPES = [(262144, 9, 8), (65536, 72, 16), (1024, 256, 10),
             (48, 2048, 8192), (48, 8192, 2048), (4096, 2048, 8192),
             (4096, 8192, 2048), (16, 8192, 64), (1, 1, 1), (65, 33, 127)]


@pytest.mark.parametrize("M,K,N", MM_SHAPES)
def test_int8_error_kernels_equal_plain(cuda, M, K, N):
    from repro_torch.kernels import abft_matmul as AB
    from repro_torch.kernels import overscale_matmul as OM
    args = _mm_inputs(M, K, N, cuda)
    before = (OM.overscale_matmul.launches, AB.abft_matmul.launches)
    c, clean = OM.overscale_matmul(*args, return_clean=True)
    want, want_clean = OM.overscale_matmul_ref(*args, return_clean=True)
    got = AB.abft_matmul(*args)
    ref = AB.abft_matmul_ref(*args)
    torch.cuda.synchronize()
    assert (OM.overscale_matmul.launches, AB.abft_matmul.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(c, want) and torch.equal(clean, want_clean)
    for x, y in zip(got, ref):
        assert torch.equal(x, y)


def test_int8_error_kernels_wrap(cuda):
    """K = 2^17 products of (-128)(-128): every accumulator wraps to -2^31
    and every checksum wraps again."""
    from repro_torch.kernels import abft_matmul as AB
    from repro_torch.kernels import overscale_matmul as OM
    M, K, N = 8, 1 << 17, 8
    a = torch.full((M, K), -128, dtype=torch.int8, device=cuda)
    b = torch.full((K, N), -128, dtype=torch.int8, device=cuda)
    never = torch.full((M, N), -1, dtype=torch.int32, device=cuda)
    cdf = OM.bit_probs_to_cdf(np.full(32, 0.01), cuda)
    got = AB.abft_matmul(a, b, never, never, cdf)
    ref = AB.abft_matmul_ref(a, b, never, never, cdf)
    assert int(got[0][0, 0]) == -2 ** 31
    for x, y in zip(got, ref):
        assert torch.equal(x, y)


def test_int8_error_kernels_wrap_and_return(cuda):
    """K = 2^18: 2^17 products of (-128)(-128) pass 2^31, then 2^17 of
    (-128)(127) come back, to 2^17 x 128 = 2^24 exactly (a saturating
    accumulator would end at 2^24 - 1); K is split across CTAs."""
    from repro_torch.kernels import abft_matmul as AB
    from repro_torch.kernels import overscale_matmul as OM
    M, K, N = 16, 1 << 18, 16
    assert OM.plan(M, K, N).splits > 1
    a = torch.full((M, K), -128, dtype=torch.int8, device=cuda)
    b = torch.full((K, N), -128, dtype=torch.int8, device=cuda)
    b[K // 2:] = 127
    g = torch.Generator(device=cuda)
    g.manual_seed(2)
    ug, ub = OM.random_planes(g, (M, N), cuda)
    cdf = OM.bit_probs_to_cdf(np.full(32, 0.01), cuda)
    c, clean = OM.overscale_matmul(a, b, ug, ub, cdf, return_clean=True)
    got = AB.abft_matmul(a, b, ug, ub, cdf)
    ref = AB.abft_matmul_ref(a, b, ug, ub, cdf, return_clean=True)
    assert bool((clean == 1 << 24).all())
    assert torch.equal(clean, ref[3]) and torch.equal(c, ref[0])
    for x, y in zip(got, ref):
        assert torch.equal(x, y)


def test_int8_error_matmul_refuses_bad_input(cuda):
    from repro_torch.kernels import overscale_matmul as OM
    a, b, ug, ub, cdf = _mm_inputs(16, 16, 16, cuda)
    with pytest.raises(ValueError):
        OM.overscale_matmul(a.to(torch.int32), b, ug, ub, cdf)
    with pytest.raises(ValueError):
        OM.overscale_matmul(a, b, ug.cpu(), ub, cdf)


def test_app_paths_kernel_equals_plain(cuda):
    """make_int8_error_matmul and AbftMatmul through the kernel and through
    the plain version, on the same seed: equal outputs and ledgers."""
    from repro_torch.kernels import overscale_matmul as OM
    from repro_torch.tolerance import AbftMatmul, TimingFaultModel
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    a = torch.randn((4096, 2048), generator=g, device=cuda)
    w = torch.randn((2048, 8192), generator=g, device=cuda) * 0.02
    probs = TimingFaultModel().bit_probs(0.70, 0.85, 65.0)
    outs = [OM.make_int8_error_matmul(probs, 3, use_kernel=k,
                                      device=cuda)(a, w) for k in (True, False)]
    assert torch.equal(*outs)
    mms = [AbftMatmul(probs, 3, use_kernel=k, device=cuda) for k in (True,
                                                                     False)]
    outs = [mm(a, w) for mm in mms]
    assert torch.equal(*outs)
    assert mms[0].counters == mms[1].counters
    assert mms[0].counters.injected > 0


# --- the attention kernels ----------------------------------------------------

def _paged_inputs(device, dtype, R=8, H=32, Hkv=8, D=64, ps=16, n=8,
                  seed=3):
    """Pages permuted across a pool with a null page; row 0 disabled
    (pos = -1), the others at positions that end mid-page."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    P = R * n
    q = torch.randn((R, H, D), generator=g, device=device).to(dtype)
    k = torch.randn((P + 1, ps, Hkv, D), generator=g, device=device).to(dtype)
    v = torch.randn((P + 1, ps, Hkv, D), generator=g, device=device).to(dtype)
    perm = torch.randperm(P, generator=g, device=device).to(torch.int32)
    bt = perm.reshape(R, n)
    pos = torch.randint(0, n * ps, (R,), generator=g, device=device).to(
        torch.int32)
    pos[0] = -1
    span = torch.arange(n * ps, device=device, dtype=torch.int32)
    ids_log = torch.where(span[None] <= pos[:, None], span[None], -1)
    ids = torch.full((P + 1, ps), -1, dtype=torch.int32, device=device)
    ids[bt.long()] = ids_log.reshape(R, n, ps).to(torch.int32)
    bt[1, 3:] = P  # a short row: the rest of its table is the null page
    return q, k, v, ids, bt, pos


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 48])
@pytest.mark.parametrize("shape", [dict(), dict(H=4, Hkv=2, D=16, ps=8),
                                   dict(H=8, Hkv=8, D=128, ps=4),
                                   dict(ps=40)])
def test_paged_attention_equals_plain(cuda, dtype, window, shape):
    from repro_torch.kernels import paged_attention as PA
    args = _paged_inputs(cuda, dtype, **shape)
    before = PA.paged_attention.launches
    got = PA.paged_attention(*args, window=window)
    want = PA.paged_attention_ref(*args, window=window)
    torch.cuda.synchronize()
    assert PA.paged_attention.launches == before + 1
    assert got.dtype == dtype
    assert (got[0] == 0).all()  # pos = -1: exact zeros
    assert torch.equal(got, want)


def _chunk_inputs(device, dtype, S, B=3, H=32, Hkv=8, D=64, ps=16, n=8,
                  seed=5):
    """Chunks of S rows per slot over a permuted pool: slot b's cache holds
    positions [0, start_b + valid_b) (its chunk just written, valid_b real
    rows, the padded tail's entries -1); its rows sit at start_b + s, two of
    slot 0's swapped (positions need not be consecutive); slot 2's last row
    is disabled (pos = -1)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed + S)
    P = B * n
    q = torch.randn((B, S, H, D), generator=g, device=device).to(dtype)
    k = torch.randn((P + 1, ps, Hkv, D), generator=g, device=device).to(dtype)
    v = torch.randn((P + 1, ps, Hkv, D), generator=g, device=device).to(dtype)
    bt = torch.randperm(P, generator=g, device=device).to(torch.int32)
    bt = bt.reshape(B, n).contiguous()
    top = n * ps - S
    start = torch.tensor([top, top // 3, 0], dtype=torch.int32,
                         device=device)[:B]
    valid = torch.tensor([S, max(1, S // 2), S], dtype=torch.int32,
                         device=device)[:B]
    pos = start[:, None] + torch.arange(S, dtype=torch.int32,
                                        device=device)[None]
    if S > 2:
        pos[0, [0, S - 1]] = pos[0, [S - 1, 0]]
    pos[-1, -1] = -1
    span = torch.arange(n * ps, dtype=torch.int32, device=device)[None]
    ids_log = torch.where(span < (start + valid)[:, None], span, -1)
    ids = torch.full((P + 1, ps), -1, dtype=torch.int32, device=device)
    ids[bt.long()] = ids_log.reshape(B, n, ps).to(torch.int32)
    bt[-1, n // 2:] = P  # a short slot: the rest of its table is null
    return q, k, v, ids, bt, pos.contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 48])
@pytest.mark.parametrize("S", [1, 4, 16, 37])
@pytest.mark.parametrize("shape", [dict(), dict(H=8, Hkv=8, D=128, ps=8),
                                   dict(H=4, Hkv=2, D=16, ps=40, n=3)])
def test_paged_attention_chunks_equal_plain(cuda, dtype, window, S, shape):
    """The chunk form (S rows per slot on the slot's table), decode (S = 1)
    and extend, bit for bit in both dtypes; and a float32 chunk, or one of
    at most 16 rows in either dtype (a speculative verify), equals the
    decode of its rows."""
    from repro_torch.kernels import paged_attention as PA
    q, k, v, ids, bt, pos = _chunk_inputs(cuda, dtype, S, **shape)
    before = PA.paged_attention.launches
    got = PA.paged_attention(q, k, v, ids, bt, pos, window=window)
    want = PA.paged_attention_ref(q, k, v, ids, bt, pos, window=window)
    torch.cuda.synchronize()
    assert PA.paged_attention.launches == before + 1
    assert got.shape == q.shape and got.dtype == dtype
    assert (got[-1, -1] == 0).all()  # pos = -1: exact zeros
    assert torch.equal(got, want)
    if dtype == torch.float32 or S <= PA.CHUNK_ROWS:
        B, _, H, D = q.shape
        rows = PA.paged_attention(
            q.reshape(B * S, H, D), k, v, ids,
            bt.repeat_interleave(S, dim=0), pos.reshape(-1), window=window)
        assert torch.equal(got.reshape(B * S, H, D), rows)


def _long_table_inputs(device, dtype, S, H=32, Hkv=8, D=64, ps=16,
                       n=2600, seed=9):
    """Two slots over a table of 2600 pages of 16 (41,600 positions), most
    of it the null page: slot 0 owns pages 0, 1, 1300 and the last three
    and its S rows end 3 positions before the table's end; slot 1 owns
    pages 0 and 1300, its rows end at 1300 * 16 + 7, its last row is
    disabled (pos = -1)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed + S)
    owned = ([0, 1, 1300, n - 3, n - 2, n - 1], [0, 1300])
    ends = (n * ps - 3, 1300 * ps + 7)
    P = sum(len(o) for o in owned)
    q = torch.randn((2, S, H, D), generator=g, device=device).to(dtype)
    k = torch.randn((P + 1, ps, Hkv, D), generator=g, device=device).to(dtype)
    v = torch.randn((P + 1, ps, Hkv, D), generator=g, device=device).to(dtype)
    bt = torch.full((2, n), P, dtype=torch.int32, device=device)
    ids = torch.full((P + 1, ps), -1, dtype=torch.int32, device=device)
    page = 0
    for b, (js, end) in enumerate(zip(owned, ends)):
        for j in js:
            bt[b, j] = page
            span = torch.arange(j * ps, (j + 1) * ps, dtype=torch.int32,
                                device=device)
            ids[page] = torch.where(span <= end, span, -1)
            page += 1
    pos = (torch.tensor(ends, dtype=torch.int32, device=device)[:, None]
           - S + 1 + torch.arange(S, dtype=torch.int32, device=device)[None])
    pos[1, -1] = -1
    return q, k, v, ids, bt, pos.contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 48])
@pytest.mark.parametrize("S", [1, 4, 37])
@pytest.mark.parametrize("D", [64, 128])
def test_paged_attention_long_table_equals_plain(cuda, dtype, window, S, D):
    """Tables past 40k positions: a block's shared memory does not grow
    with the table (it reads the table a window at a time), and every path
    stays bit for bit equal to its plain version."""
    from repro_torch.kernels import paged_attention as PA
    q, k, v, ids, bt, pos = _long_table_inputs(cuda, dtype, S, D=D)
    got = PA.paged_attention(q, k, v, ids, bt, pos, window=window)
    want = PA.paged_attention_ref(q, k, v, ids, bt, pos, window=window)
    torch.cuda.synchronize()
    assert (got[1, -1] == 0).all()  # pos = -1: exact zeros
    assert bool(got[0].float().abs().sum() > 0)
    assert torch.equal(got, want)


def test_paged_attention_refuses_bad_input(cuda):
    from repro_torch.kernels import paged_attention as PA
    q, k, v, ids, bt, pos = _paged_inputs(cuda, torch.float32)
    with pytest.raises(ValueError):
        PA.paged_attention(q, k.to(torch.bfloat16), v, ids, bt, pos)
    with pytest.raises(ValueError):
        PA.paged_attention(q, k, v, ids, bt.long(), pos)
    with pytest.raises(ValueError):
        PA.paged_attention(q, k, v, ids, bt, pos.cpu())


_MMA_PROBE = r"""
#include <stdint.h>
extern "C" __global__ void probe(const uint32_t* a, const uint32_t* b,
                                 float* c, int n) {
  const long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= 32LL * n) return;
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[4 * o]), "+f"(c[4 * o + 1]), "+f"(c[4 * o + 2]),
        "+f"(c[4 * o + 3])
      : "r"(a[4 * o]), "r"(a[4 * o + 1]), "r"(a[4 * o + 2]),
        "r"(a[4 * o + 3]), "r"(b[2 * o]), "r"(b[2 * o + 1]));
}
extern "C" int run(const void* a, const void* b, void* c, int n) {
  probe<<<(32 * n + 127) / 128, 128>>>((const uint32_t*)a,
                                       (const uint32_t*)b, (float*)c, n);
  return (int)cudaDeviceSynchronize();
}
"""


def test_tensor_core_model_equals_mma_sync(cuda, tmp_path):
    """The plain versions' model of one m16n8k16 step
    (``flash_attention.tensor_core_mma``) against the card's mma.sync on
    8192 random steps (1,048,576 outputs): bf16 inputs with exponents
    spread over +-12 and an accumulator over +-20, narrow spreads with a
    large accumulator, and products that cancel; bit for bit."""
    import ctypes
    import subprocess
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as FA
    src = tmp_path / "mma_probe.cu"
    src.write_text(_MMA_PROBE)
    lib_path = tmp_path / "mma_probe.so"
    subprocess.run([_build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o",
                    str(lib_path), str(src)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.run.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    N, q = 8192, 2048

    def spread(shape, lo, hi):
        e = torch.randint(lo, hi + 1, shape, generator=g, device=cuda)
        return torch.randn(shape, generator=g, device=cuda) * torch.exp2(
            e.float())

    A, B, C = spread((N, 16, 16), 0, 0), spread((N, 16, 8), 0, 0), \
        4 * spread((N, 16, 8), 0, 0)
    A[q:2 * q], B[q:2 * q] = spread((q, 16, 16), -12, 12), \
        spread((q, 16, 8), -12, 12)
    C[q:2 * q] = spread((q, 16, 8), -20, 20)
    A[2 * q:3 * q], B[2 * q:3 * q] = spread((q, 16, 16), -2, 2), \
        spread((q, 16, 8), -2, 2)
    C[2 * q:3 * q] = spread((q, 16, 8), -4, 12)
    C[3 * q:] = 0.0
    B[3 * q:, 8:] = -B[3 * q:, :8]
    A[3 * q:, :, 8:] = A[3 * q:, :, :8]
    A[3 * q:, :, 12:] *= 1.5
    A, B = A.bfloat16(), B.bfloat16()
    # the fragments of lane l (g = l / 4, t = l % 4): A rows g, g + 8 and
    # columns 2t, 2t + 1 (+ 8); B rows 2t, 2t + 1 (+ 8) of column g; C rows
    # g, g + 8 and columns 2t, 2t + 1
    lane = torch.arange(32, device=cuda)
    gq, t = lane // 4, lane % 4
    pair = lambda x0, x1: torch.stack([x0, x1], -1).contiguous().view(
        torch.int32)[..., 0]
    a = torch.stack([pair(A[:, r, c], A[:, r, c + 1]) for r, c in (
        (gq, 2 * t), (gq + 8, 2 * t), (gq, 2 * t + 8), (gq + 8, 2 * t + 8))],
        -1)
    b = torch.stack([pair(B[:, 2 * t, gq], B[:, 2 * t + 1, gq]),
                     pair(B[:, 2 * t + 8, gq], B[:, 2 * t + 9, gq])], -1)
    cells = ((gq, 2 * t), (gq, 2 * t + 1), (gq + 8, 2 * t),
             (gq + 8, 2 * t + 1))
    c = torch.stack([C[:, r, col] for r, col in cells], -1).contiguous()
    assert lib.run(a.contiguous().data_ptr(), b.contiguous().data_ptr(),
                   c.data_ptr(), N) == 0
    D = torch.empty_like(C)
    for i, (r, col) in enumerate(cells):
        D[:, r, col] = c[..., i]
    want = FA.tensor_core_mma(A.float(), B.float(), C)
    assert torch.equal(D.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,Hkv,D", [(2, 128, 4, 2, 64), (1, 37, 4, 4, 16),
                                         (2, 100, 8, 2, 32),
                                         (1, 130, 4, 1, 128)])
def test_flash_attention_equals_plain(cuda, dtype, causal, B, S, H, Hkv, D):
    from repro_torch.kernels import flash_attention as FA
    g = torch.Generator(device=cuda)
    g.manual_seed(S)
    q = torch.randn((B, S, H, D), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, S, Hkv, D), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, S, Hkv, D), generator=g, device=cuda).to(dtype)
    before = FA.flash_attention.launches
    got = FA.flash_attention(q, k, v, causal=causal)
    want = FA.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,T,H,Hkv,D", [(1, 1601, 32, 8, 128),
                                         (64, 1601, 32, 8, 128),
                                         (256, 1601, 32, 8, 128),
                                         (1, 1500, 12, 12, 64),
                                         (256, 1500, 12, 12, 64),
                                         (37, 300, 4, 2, 16)])
def test_flash_attention_cross_shapes_equal_plain(cuda, dtype, S, T, H, Hkv,
                                                  D):
    """The multimodal paths' non-causal calls, S != T (the vlm's cross
    steps over 1601 image tokens, whisper's over 1500 frames, an odd edge):
    bit for bit with the plain version."""
    from repro_torch.kernels import flash_attention as FA
    g = torch.Generator(device=cuda)
    g.manual_seed(S + T)
    q = torch.randn((2, S, H, D), generator=g, device=cuda).to(dtype)
    k = torch.randn((2, T, Hkv, D), generator=g, device=cuda).to(dtype)
    v = torch.randn((2, T, Hkv, D), generator=g, device=cuda).to(dtype)
    got = FA.flash_attention(q, k, v, causal=False)
    want = FA.flash_attention_ref(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_mla_paged_engine_equals_contiguous_on_the_card(cuda):
    """The reduced deepseek-v2 in float32 on the card: the paged engine
    (MLA's compressed rows in pages) serves the contiguous engine's greedy
    tokens, a preemption and its resume included."""
    from repro_torch.configs import registry
    from repro_torch.models.model import Model
    from repro_torch.serve import Engine, Request
    cfg = registry.get("deepseek-v2-236b").reduced().replace(dtype="float32")
    model = Model(cfg, device=cuda).init(0)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (5, 30, 9)]
    outs = {}
    for paged in (False, True):
        eng = Engine(model, batch_slots=2, max_len=64, eos_id=-1,
                     paged=paged)
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid, p, max_new=10))
        ticks = 0
        while eng.step():
            ticks += 1
            if ticks == 4:
                assert eng.preempt_to(1) == 1
        outs[paged] = {r.rid: tuple(r.out) for r in eng.finished}
    assert outs[True] == outs[False]


def test_routed_forward_through_the_abft_kernel_equals_plain(cuda):
    """A reduced llama forward with its MLP products routed through
    ``AbftMatmul`` at a rail below the guard band: through the kernel, the
    ledger and the logits bit for bit those of ``use_kernel=False``."""
    from repro_torch.configs import registry
    from repro_torch.core import tpu_fleet as TF
    from repro_torch.kernels import abft_matmul as AB
    from repro_torch.models.model import Model
    from repro_torch.tolerance import (AbftMatmul, TimingFaultModel,
                                       routed_matmuls)
    cfg = registry.get("llama3.2-1b").reduced()
    model = Model(cfg, device=cuda).init(0)
    toks = torch.arange(48, device=cuda).reshape(2, 24) % cfg.vocab_size
    probs = TimingFaultModel().bit_probs(0.700, TF.V_SRAM_NOM, 65.0)
    runs = []
    for use_kernel in (True, False):
        mm = AbftMatmul(probs, 9, use_kernel=use_kernel, device=cuda)
        before = AB.abft_matmul.launches
        with routed_matmuls(mm):
            logits = model.apply({"tokens": toks})[0]
        torch.cuda.synchronize()
        assert AB.abft_matmul.launches - before == (
            3 * cfg.num_layers if use_kernel else 0)
        runs.append((mm.counters, logits))
    assert runs[0][0] == runs[1][0] and runs[0][0].injected > 0
    assert torch.equal(runs[0][1], runs[1][1])


def test_model_and_engine_on_the_card(cuda):
    """The reduced llama in float32 on the card: the model through the
    kernels equals the model through the plain versions bit for bit, and
    the paged engine's greedy tokens equal the contiguous engine's."""
    from repro_torch.configs import registry
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.models import attention as attn
    from repro_torch.models.model import Model
    from repro_torch.serve import Engine, Request
    cfg = registry.get("llama3.2-1b").reduced().replace(dtype="float32")
    model = Model(cfg, device=cuda).init(0)
    toks = torch.arange(64, device=cuda).reshape(2, 32) % cfg.vocab_size
    got, _ = model.apply({"tokens": toks})
    with attn.plain_kernels():
        want, _ = model.apply({"tokens": toks})
    assert torch.equal(got, want)
    outs = {}
    for paged in (False, True):
        eng = Engine(model, batch_slots=2, max_len=64, eos_id=-1,
                     paged=paged)
        for rid in range(4):
            eng.submit(Request(rid, (np.arange(5 + 7 * rid) * 3 + rid)
                               .astype(np.int32) % cfg.vocab_size,
                               max_new=12))
        before = PA.paged_attention.launches
        eng.run()
        outs[paged] = {r.rid: tuple(r.out) for r in eng.finished}
        assert (PA.paged_attention.launches > before) == paged
    assert outs[True] == outs[False]


# --- the sliding-window ring (mixtral) ------------------------------------------

RING_W = 256  # a ring as long as the window: 16 pages of 16


def _ring_inputs(device, dtype, S, H=32, Hkv=8, D=128, ps=16, seed=13):
    """The serving tier's wrapped ring at mixtral's head shapes: per slot a
    table of 16 ring pages (the pre-update ring, position p at ring index
    p % 256) then 16 scratch pages (the chunk of S rows at ``start + j``,
    the padded tail's ids -1), over a permuted pool with a null page.
    Slots start at 300 and 611 (wrapped; 611 mid-page), 0 (an empty ring)
    and 1000; slot 1 has 100 real rows of a 256-row chunk, slot 2's last
    row is disabled (pos = -1)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed + S)
    n = RING_W // ps
    starts = [300, 611, 0, 1000]
    valid = [S, min(S, 100), S, S]
    B = len(starts)
    P = B * 2 * n
    q = torch.randn((B, S, H, D), generator=g, device=device).to(dtype)
    k = torch.randn((P + 1, ps, Hkv, D), generator=g, device=device).to(dtype)
    v = torch.randn((P + 1, ps, Hkv, D), generator=g, device=device).to(dtype)
    bt = torch.randperm(P, generator=g, device=device).to(torch.int32)
    bt = bt.reshape(B, 2 * n).contiguous()
    ids = torch.full((P + 1, ps), -1, dtype=torch.int32, device=device)
    idx = torch.arange(RING_W, dtype=torch.int32, device=device)
    for b, (s, nv) in enumerate(zip(starts, valid)):
        last = s - 1 - ((s - 1 - idx) % RING_W)  # newest p < s at index i
        ring = torch.where(last >= 0, last, -1)
        chunk = torch.where(idx < nv, s + idx, -1)
        ids[bt[b].long()] = torch.cat([ring, chunk]).reshape(2 * n, ps)
    bt[2, 1:n] = P  # the empty ring: one page, the rest the null page
    pos = (torch.tensor(starts, dtype=torch.int32, device=device)[:, None]
           + torch.arange(S, dtype=torch.int32, device=device)[None])
    pos[2, -1] = -1
    return q, k, v, ids, bt, pos.contiguous()


def _ring_visible(ids, bt, pos, window):
    """(B, S, n * ps) bool: the entries each row may see (chip_smoke's
    ``_visible_keys``): 0 <= id <= pos and id > pos - window."""
    seen = ids[bt.long()].reshape(bt.shape[0], 1, -1).long()
    p = pos.reshape(bt.shape[0], -1, 1).long()
    return (seen >= 0) & (seen <= p) & (seen > p - window)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 256])
def test_paged_ring_with_scratch_equals_plain(cuda, dtype, S):
    """Decode rows and 256-row chunks over a wrapped ring and its scratch
    pages, the window bound on: bit for bit with the plain version."""
    from repro_torch.kernels import paged_attention as PA
    args = _ring_inputs(cuda, dtype, S)
    got = PA.paged_attention(*args, window=RING_W)
    want = PA.paged_attention_ref(*args, window=RING_W)
    torch.cuda.synchronize()
    assert (got[2, -1] == 0).all()  # pos = -1: exact zeros
    assert torch.equal(got, want)


@pytest.mark.parametrize("S", [1, 256])
def test_windowed_chunk_sees_exactly_the_visible_keys(cuda, S):
    """Through the kernel each row attends exactly the entries the window
    rule names: changing every entry no row may see leaves the output bit
    for bit, and the output is float64 softmax attention over exactly the
    visible set (float32, 1e-5)."""
    from repro_torch.kernels import paged_attention as PA
    q, k, v, ids, bt, pos = _ring_inputs(cuda, torch.float32, S)
    got = PA.paged_attention(q, k, v, ids, bt, pos, window=RING_W)
    vis = _ring_visible(ids, bt, pos, RING_W)  # (B, S, n * ps)
    ps, Hkv, D = k.shape[1], k.shape[2], k.shape[3]
    entries = torch.zeros(k.shape[:2], dtype=torch.bool, device=cuda)
    B, n = bt.shape
    seen_any = vis.any(1).reshape(B, n, ps)
    entries[bt.long()] |= seen_any
    k2, v2 = k.clone(), v.clone()
    k2[~entries] = 100.0
    v2[~entries] = -100.0
    again = PA.paged_attention(q, k2, v2, ids, bt, pos, window=RING_W)
    assert torch.equal(got, again)
    heads = torch.arange(q.shape[2], device=cuda) // (q.shape[2] // Hkv)
    kl = k[bt.long()].reshape(B, n * ps, Hkv, D)[:, :, heads].double()
    vl = v[bt.long()].reshape(B, n * ps, Hkv, D)[:, :, heads].double()
    s = torch.einsum("bshd,bthd->bhst", q.double(), kl) / D ** 0.5
    s = s.masked_fill(~vis[:, None], float("-inf"))
    w = torch.nan_to_num(torch.softmax(s, -1), nan=0.0)
    want = torch.einsum("bhst,bthd->bshd", w, vl)
    assert float((got.double() - want).abs().max()) <= 1e-5


def test_moe_routes_on_the_card_equal_the_cpu_port(cuda):
    """The reduced mixtral's routes (experts chosen, the capacity's kept
    routes; capacity factor 1.25, so some drop) and logits, card against
    the CPU port on the same weights: routes equal, logits within 1e-4."""
    from repro_torch.configs import registry
    from repro_torch.models import moe
    from repro_torch.models.model import Model
    cfg = registry.get("mixtral-8x7b").reduced().replace(dtype="float32")
    cpu = Model(cfg, device="cpu").init(0)
    card = Model(cfg, device=cuda).load_reference(cpu.weights())
    toks = np.random.default_rng(0).integers(0, 256, (4, 16))
    runs = {}
    for name, model in (("card", card), ("cpu", cpu)):
        with moe.capture_routes() as routes:
            logits, _ = model.apply({"tokens": toks})
        runs[name] = (logits.cpu(), routes)
    dropped = 0
    for a, b in zip(runs["card"][1], runs["cpu"][1]):
        assert torch.equal(a["idx"].cpu(), b["idx"])
        assert torch.equal(a["keep"].cpu(), b["keep"])
        dropped += int((~b["keep"]).sum())
    assert dropped > 0
    assert float((runs["card"][0] - runs["cpu"][0]).abs().max()) <= 1e-4


def test_swa_engine_on_the_card(cuda):
    """The reduced mixtral with a 32-entry ring in float32 on the card: the
    paged engine (the kernel with the window bound, chunks through the
    scratch pages) serves the contiguous engine's tokens, prompts that
    wrap the ring included."""
    from repro_torch.configs import registry
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.models.model import Model
    from repro_torch.serve import Engine, Request
    cfg = registry.get("mixtral-8x7b").reduced().replace(dtype="float32",
                                                         sliding_window=32)
    model = Model(cfg, device=cuda).init(0)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, n).astype(np.int32)
               for n in (5, 40, 50, 9)]
    outs = {}
    for paged in (False, True):
        eng = Engine(model, batch_slots=2, max_len=64, eos_id=-1,
                     prefill_chunk=12, paged=paged)
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid, p, max_new=12))
        before = PA.paged_attention.launches
        eng.run()
        outs[paged] = {r.rid: tuple(r.out) for r in eng.finished}
        assert (PA.paged_attention.launches > before) == paged
    assert outs[True] == outs[False]


@pytest.mark.parametrize("paged", [False, True])
def test_verify_rows_equal_decode_rows_bf16(cuda, paged):
    """The reduced llama in bf16 on the card: a speculative verify tick (4
    rows, the drafts set to greedy's next 3 tokens) gives each row the
    logits of the decode tick it stands for, bit for bit."""
    from repro_torch.configs import registry
    from repro_torch.models.model import Model
    from repro_torch.serve import Engine, Request
    cfg = registry.get("llama3.2-1b").reduced()
    model = Model(cfg, device=cuda).init(0)
    eng = Engine(model, batch_slots=8, max_len=64, eos_id=-1, paged=paged,
                 prefill_chunk=32)
    for rid, n in enumerate((5, 20, 9)):
        eng.submit(Request(rid, (np.arange(n) * 3 + rid).astype(np.int32)
                           % cfg.vocab_size, max_new=16))
    eng.step()
    plan, _ = eng._compose()
    assert plan.width == 1
    live = [w.slot for w in plan.work]
    if paged:
        for slot in live:
            eng.mgr.extend(slot, int(eng.mgr.pos[slot]) + 4)
    cache = (eng.mgr.pool if paged else eng.mgr.cache)["stack"]
    saved = {name: v.clone() for name, v in cache.items()}
    step = (plan.n_valid > 0).astype(np.int32)
    rows, toks = [], plan.tokens.copy()
    greedy = np.zeros((plan.tokens.shape[0], 4), np.int32)
    for j in range(4):
        logits = eng.step_logits(toks, plan.pos + j * step, plan.n_valid)
        rows.append(logits)
        greedy[:, j] = toks[:, 0]
        toks = logits.argmax(-1).to(torch.int32).cpu().numpy()
    for name, v in saved.items():
        cache[name].copy_(v)
    verify = eng.step_logits(greedy, plan.pos, step * 4)
    assert torch.equal(verify[live], torch.cat(rows, dim=1)[live])


def _scan_inputs(b, S, H, P, G, N, dtype, device, seed):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    r = lambda *shape: torch.randn(shape, generator=g, device=device)
    xh = (0.5 * r(b, S, H, P)).to(dtype)
    dt = torch.nn.functional.softplus(r(b, S, H)).to(dtype)
    A = -torch.exp(0.3 * r(H))
    return xh, dt, A, (0.3 * r(b, S, G, N)).to(dtype), \
        (0.3 * r(b, S, G, N)).to(dtype)


# (b, S, H, P, G, N, chunk) of the scan's card tests
SCAN_SHAPES = [
    (2, 128, 4, 16, 4, 32, 32), (2, 256, 8, 32, 8, 64, 64),
    (2, 64, 2, 8, 2, 16, 64),  # the reference test shapes (G = H)
    (1, 32, 2, 4, 2, 8, 8),  # the sequential-oracle shape
    (1, 512, 4, 64, 1, 128, 256),  # mamba2's chunk and state, two chunks
    (2, 256, 4, 64, 1, 64, 256),  # zamba2's
    (1, 40, 3, 24, 1, 16, 64),  # Q = 40 rows, P = 24: ragged tiles
    (1, 100, 48, 64, 1, 128, 256),  # mamba2's widths at a ragged prompt
    (3, 96, 4, 20, 2, 48, 32),  # P-tile edge, groups of 2 heads
    (4, 512, 48, 64, 1, 128, 256),  # mamba2's widths at B = 4
    # C B^T shared by 12 heads, by one, and by 32 at zamba2's widths
    (2, 512, 48, 64, 4, 128, 256), (2, 512, 48, 64, 48, 128, 256),
    (2, 256, 64, 64, 2, 64, 256),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,S,H,P,G,N,chunk", SCAN_SHAPES)
def test_mamba_scan_equals_plain(cuda, dtype, b, S, H, P, G, N, chunk):
    from repro_torch.kernels import mamba_scan as MS
    args = _scan_inputs(b, S, H, P, G, N, dtype, cuda, seed=S + P + N)
    before = MS.mamba_scan.launches
    y, state = MS.mamba_scan(*args, chunk=chunk)
    y_p, s_p = MS.mamba_scan_ref(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert MS.mamba_scan.launches == before + 1
    assert y.dtype == dtype and state.dtype == torch.float32
    assert torch.equal(y, y_p) and torch.equal(state, s_p)


def test_mamba_scan_on_a_side_stream_and_in_a_graph(cuda):
    """After a call on the default stream, a call on a side stream and a
    CUDA graph of two calls (another shape between them) each equal the
    plain version: every stream, and the graph, has a C B^T scratch of its
    own."""
    from repro_torch.kernels import mamba_scan as MS
    small = _scan_inputs(1, 256, 8, 64, 2, 128, torch.bfloat16, cuda, seed=3)
    big = _scan_inputs(2, 512, 8, 64, 1, 128, torch.bfloat16, cuda, seed=4)
    want = {id(a): MS.mamba_scan_ref(*a, chunk=256) for a in (small, big)}

    def held(args, got):
        y_p, s_p = want[id(args)]
        assert torch.equal(got[0], y_p) and torch.equal(got[1], s_p)

    held(big, MS.mamba_scan(*big, chunk=256))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        on_side = MS.mamba_scan(*small, chunk=256)
        MS.mamba_scan(*big, chunk=256)  # a warm-up off the default stream
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    held(small, on_side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        first = MS.mamba_scan(*big, chunk=256)
        second = MS.mamba_scan(*small, chunk=256)
    for out in (first, second):
        out[0].zero_()
    graph.replay()
    held(big, MS.mamba_scan(*big, chunk=256))  # the default stream between
    torch.cuda.synchronize()
    held(big, first)
    held(small, second)


def test_mamba_scan_refuses_bad_input(cuda):
    from repro_torch.kernels import mamba_scan as MS
    xh, dt, A, B, C = _scan_inputs(1, 64, 4, 16, 1, 32, torch.float32, cuda,
                                   seed=1)
    with pytest.raises(ValueError, match="ssm_chunk"):
        MS.mamba_scan(xh[:, :40], dt[:, :40], A, B[:, :40], C[:, :40],
                      chunk=32)
    with pytest.raises(ValueError):
        MS.mamba_scan(xh, dt.to(torch.bfloat16), A, B, C, chunk=32)
    with pytest.raises(ValueError):
        MS.mamba_scan(xh, dt, A.cpu(), B, C, chunk=32)
    big = torch.zeros((1, 64, 1, 256), device=cuda)
    with pytest.raises(ValueError, match="state"):
        MS.mamba_scan(xh, dt, A, big, big, chunk=32)


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-1.2b"])
def test_recurrent_model_and_engine_on_the_card(cuda, arch):
    """The reduced recurrent models in float32 on the card: the forward
    through the kernels equals the plain versions' bit for bit, and the
    stateful engine's greedy tokens through the kernels equal those through
    the plain versions, with one scan launch per mamba layer and prefill."""
    from repro_torch.configs import registry
    from repro_torch.kernels import mamba_scan as MS
    from repro_torch.models import attention as attn
    from repro_torch.models.model import Model
    from repro_torch.serve import Engine, Request
    cfg = registry.get(arch).reduced().replace(dtype="float32")
    model = Model(cfg, device=cuda).init(0)
    toks = torch.arange(128, device=cuda).reshape(2, 64) % cfg.vocab_size
    got, _ = model.apply({"tokens": toks})
    with attn.plain_kernels():
        want, _ = model.apply({"tokens": toks})
    assert torch.equal(got, want)
    outs = {}
    for plain in (False, True):
        eng = Engine(model, batch_slots=2, max_len=96, eos_id=-1)
        for rid, n in enumerate((5, 32, 64)):
            eng.submit(Request(rid, (np.arange(n) * 3 + rid)
                               .astype(np.int32) % cfg.vocab_size,
                               max_new=12))
        before = MS.mamba_scan.launches
        with attn.plain_kernels() if plain else contextlib.nullcontext():
            eng.run()
        outs[plain] = {r.rid: tuple(r.out) for r in eng.finished}
        assert MS.mamba_scan.launches - before == (
            0 if plain else 3 * cfg.num_layers)
    assert outs[True] == outs[False]


@pytest.mark.parametrize("t_sweep", [(10.0, 45.0, 8), (10.0, 45.0, 4)],
                         ids=["railfield", "serve_replay"])
def test_railfield_on_the_card_equals_the_cpu_port(cuda, t_sweep):
    """The 16x16 pod's RailField built on the card (one early-freeze
    solve_batch over the knots, batched direct-tier thermal solves) has
    the CPU port's rails at every knot and chip, and its nominal-power grid
    within 1e-3; the ambient knots of tests/test_railfield.py and of
    serve_replay, the utilization knots 0.25 to 1 in four."""
    from repro_torch.control import sweep_points
    from repro_torch.core import runtime as RT
    from repro_torch.core import tpu_fleet as TF
    prof = TF.StepProfile.from_roofline(compute_s=0.8, memory_s=0.45,
                                        collective_s=0.2)
    knots = (sweep_points(*t_sweep), sweep_points(0.25, 1.0, 4))
    card = RT.EnergyAwareRuntime(prof, device=cuda).build_field(*knots)
    cpu = RT.EnergyAwareRuntime(prof, device="cpu").build_field(*knots)
    np.testing.assert_array_equal(card.vc, cpu.vc)
    np.testing.assert_array_equal(card.vs, cpu.vs)
    np.testing.assert_allclose(card.p_nom, cpu.p_nom, rtol=1e-3)


def test_clean_fleet_day_is_pod_count_invariant_on_the_card(cuda):
    """The §10 contract on the card: a clean day through ``fleet_replay``
    at 1 and 2 pods gives the same rails, energy and condemned set (one
    shared solve per environment and tick, sliced), and the 2-pod day's
    events and rails equal the CPU port's."""
    from repro_torch import scenarios as sc
    from repro_torch.core import runtime as RT
    from repro_torch.core import tpu_fleet as TF
    prof = TF.StepProfile.from_roofline(compute_s=0.8, memory_s=0.45,
                                        collective_s=0.2)
    kw = dict(sweep=(15.0, 40.0, 4), util_sweep=(0.25, 1.0, 3))
    day = sc.diurnal_load_spike(ticks=10)
    rt = RT.EnergyAwareRuntime(prof, device=cuda)
    runs = {n: sc.fleet_replay(day, n_pods=n, runtime=rt, **kw)
            for n in (1, 2)}
    assert runs[1].fleet_fingerprint == runs[2].fleet_fingerprint
    cpu = sc.fleet_replay(day, n_pods=2, runtime=RT.EnergyAwareRuntime(
        prof, device="cpu"), **kw)
    np.testing.assert_array_equal(runs[2].rails, cpu.rails)
    assert runs[2].replan_reasons == cpu.replan_reasons
    assert runs[2].energy_j == pytest.approx(cpu.energy_j, rel=1e-3)


def test_foreign_resume_guard_with_engines_on_the_card(cuda):
    """Two paged engines on the card over one host pool: a request parked
    by one engine whose pages its origin still owns is refused by the
    other; once freed it resumes there (a migration) and finishes with the
    undisturbed engine's tokens."""
    from repro_torch.configs import registry
    from repro_torch.models.model import Model
    from repro_torch.serve import Engine, Request
    from repro_torch.serve.cache import HostPagePool
    cfg = registry.get("llama3.2-1b").reduced().replace(dtype="float32")
    model = Model(cfg, device=cuda).init(0)
    prompt = (np.arange(21) * 3 + 5).astype(np.int32) % cfg.vocab_size

    def engine(pool=None):
        return Engine(model, batch_slots=2, max_len=64, eos_id=-1,
                      paged=True, pool=pool)

    ref = engine()
    ref.submit(Request(0, prompt, max_new=12))
    ref.run()
    want = list(ref.finished[0].out)

    pool = HostPagePool()
    home, away = engine(pool), engine(pool)
    home.submit(Request(0, prompt, max_new=12))
    for _ in range(4):
        home.step()
    (req,) = [r for r in home.slot_req if r is not None]
    slot = home.slot_req.index(req)
    pages = home.mgr.slot_pages(slot)
    pool.put(req.rid, home.mgr.read_rows([slot]), int(home.mgr.pos[slot]),
             pages=pages, owner=home.mgr,
             page_ids=home.mgr.block_table[slot, :pages].copy(),
             freed=False)
    with pytest.raises(RuntimeError, match="foreign"):
        pool.take(req.rid, owner=away.mgr)
    pool.put(req.rid, home.mgr.read_rows([slot]), int(home.mgr.pos[slot]),
             pages=pages, owner=home.mgr, freed=True)
    home.slot_req[slot] = None
    home.mgr.free(slot)
    away.submit(req)
    away.run()
    assert pool.migrations == 1
    assert list(away.finished[0].out) == want


# --- gradients through the kernels (training) ---------------------------------

def _attn64_grads(q, k, v, do, causal):
    """(dq, dk, dv) of a materialised float64 softmax attention, by
    autograd."""
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    heads = torch.arange(H, device=q.device) // (H // Hkv)
    leaves = [t.detach().double().requires_grad_() for t in (q, k, v)]
    qd, kd, vd = leaves
    s = torch.einsum("bshd,bthd->bhst", qd, kd[:, :, heads]) / D ** 0.5
    if causal:
        hide = torch.arange(T, device=q.device)[None] > \
            torch.arange(S, device=q.device)[:, None]
        s = s.masked_fill(hide, float("-inf"))
    o = torch.einsum("bhst,bthd->bshd", torch.softmax(s, -1), vd[:, :, heads])
    return torch.autograd.grad(o, leaves, do.double())


# dq, dk, dv as a share of each gradient's largest magnitude: float32 sums
# in another order; bf16 outputs and gradients rounded to 2^-9
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,S,T,H,Hkv,D", [
    (True, 300, 300, 8, 2, 64), (False, 300, 300, 4, 4, 64),
    (False, 37, 211, 8, 2, 128), (False, 1, 150, 4, 4, 32)])
def test_flash_function_gradients(cuda, dtype, causal, S, T, H, Hkv, D):
    """The flash Function on the card (the kernel forward, the plain
    backward): its output is the kernel's, bit for bit, and dq, dk, dv
    agree with float64 autograd."""
    from repro_torch.kernels import flash_attention as FA
    g = torch.Generator(device=cuda).manual_seed(3)
    mk = lambda *s: torch.randn(s, generator=g, device=cuda).to(dtype)
    q, k, v, do = mk(2, S, H, D), mk(2, T, Hkv, D), mk(2, T, Hkv, D), \
        mk(2, S, H, D)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    n0 = FA.flash_attention.launches
    o = FA.flash_attention(*leaves, causal=causal)
    assert FA.flash_attention.launches == n0 + 1
    assert torch.equal(o.detach(), FA.flash_attention(q, k, v,
                                                      causal=causal))
    got = torch.autograd.grad(o, leaves, do)
    want = _attn64_grads(q, k, v, do, causal)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        assert (a.double() - b).abs().max() <= GRAD_TOL[dtype] * \
            b.abs().max()


def test_scan_function_gradients(cuda):
    """The scan Function on the card: y is the kernel's, the gradients are
    autograd's through the plain version (up to the order of the atomics
    that sum B's and C's shares over the heads of a group)."""
    from repro_torch.kernels import mamba_scan as MS
    g = torch.Generator(device=cuda).manual_seed(4)
    mk = lambda *s: torch.randn(s, generator=g, device=cuda)
    b, S, H, P, G, N = 2, 128, 8, 32, 2, 64
    ins = [mk(b, S, H, P), torch.nn.functional.softplus(mk(b, S, H)),
           -torch.exp(mk(H) * 0.5), mk(b, S, G, N), mk(b, S, G, N)]
    leaves = [t.clone().requires_grad_() for t in ins]
    y, state = MS.mamba_scan(*leaves, chunk=64)
    y0, s0 = MS.mamba_scan(*ins, chunk=64)
    assert torch.equal(y.detach(), y0) and torch.equal(state, s0)
    dy = mk(*y.shape)
    got = torch.autograd.grad(y, leaves, dy)
    ref, _ = MS.mamba_scan_ref(*leaves, chunk=64)
    want = torch.autograd.grad(ref, leaves, dy)
    for a, w in zip(got, want):
        assert (a - w).abs().max() <= 1e-5 * w.abs().max()


@pytest.mark.parametrize("arch", ["llama3.2-1b", "whisper-small",
                                  "mamba2-780m"])
def test_every_leaf_gets_a_gradient_on_the_card(cuda, arch):
    """A small config through the kernels (remat on): every leaf's gradient
    is nonzero (one that stopped at a kernel would leave the attention's
    or the mixer's projections at 0) and equals the plain path's
    (``attention.plain_kernels``) within float32 rounding. The gated
    cross-attention's ``gate`` is set to 0.5: at its init 0 the block
    passes nothing, and its projections get no gradient by design."""
    from repro_torch.configs import registry
    from repro_torch.models import attention as attn
    from repro_torch.models import params as pm
    from repro_torch.models.model import Model
    from repro_torch.train.step import make_grad_fn
    cfg = registry.get(arch).reduced().replace(dtype="float32",
                                               remat="full")
    model = Model(cfg, device=cuda).init(0)
    gates = [p for n, p in model.named_parameters() if n.endswith("gate")]
    for p in gates:
        p.data.fill_(0.5)
    g = torch.Generator(device=cuda).manual_seed(6)
    toks = torch.randint(0, cfg.vocab_size, (2, 33), device=cuda,
                         generator=g)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "audio":
        batch["audio_frames"] = 0.1 * torch.randn(
            (2, cfg.encoder_frames, cfg.d_model), device=cuda, generator=g)
    _, _, grads = make_grad_fn(model)(model.weights(), batch)
    with attn.plain_kernels():
        _, _, ref = make_grad_fn(model)(model.weights(), batch)
    for a, b in zip(pm.tree_leaves(grads), pm.tree_leaves(ref)):
        assert float(a.norm()) > 0
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()


# --- expandable serving and the SPMD tier on one card ----------------------------

def test_paged_attention_on_a_table_widened_mid_run(cuda):
    """The expandable paged engine widens a slot's block table between
    ticks with null-page columns: the kernel at each width (its split-K
    count follows the width) equals its plain version bit for bit, on
    decode rows and on a chunk."""
    from repro_torch.kernels import paged_attention as PA
    g = torch.Generator(device=cuda)
    g.manual_seed(21)
    B, H, Hkv, D, ps, P = 3, 32, 8, 64, 16, 40
    for dtype in (torch.float32, torch.bfloat16):
        k = torch.randn((P + 1, ps, Hkv, D), generator=g, device=cuda).to(
            dtype)
        v = torch.randn((P + 1, ps, Hkv, D), generator=g, device=cuda).to(
            dtype)
        ids = torch.full((P + 1, ps), -1, dtype=torch.int32, device=cuda)
        owned = [4, 3, 2]  # pages per slot, the rest of a row null
        bt_full = torch.full((B, 64), P, dtype=torch.int32, device=cuda)
        page, ends = 0, []
        for b, n in enumerate(owned):
            for j in range(n):
                bt_full[b, j] = page
                ids[page] = torch.arange(j * ps, (j + 1) * ps,
                                         dtype=torch.int32, device=cuda)
                page += 1
            ends.append(n * ps - 5)
        for width in (4, 8, 16, 32, 64):  # the doublings of a growth
            bt = bt_full[:, :width].contiguous()
            pos = torch.tensor(ends, dtype=torch.int32, device=cuda)
            q = torch.randn((B, H, D), generator=g, device=cuda).to(dtype)
            before = PA.paged_attention.launches
            got = PA.paged_attention(q, k, v, ids, bt, pos)
            assert PA.paged_attention.launches == before + 1
            assert torch.equal(got, PA.paged_attention_ref(q, k, v, ids, bt,
                                                           pos))
            qc = torch.randn((B, 4, H, D), generator=g, device=cuda).to(dtype)
            pc = (pos[:, None] - 3 + torch.arange(
                4, dtype=torch.int32, device=cuda)[None]).contiguous()
            got = PA.paged_attention(qc, k, v, ids, bt, pc)
            assert torch.equal(got, PA.paged_attention_ref(qc, k, v, ids, bt,
                                                           pc))


def test_expandable_engine_on_the_card(cuda):
    """The reduced llama in float32 on the card, with traffic that doubles
    the capacity: the expandable engines' tokens, contiguous and paged,
    equal the fixed-size engines'."""
    from repro_torch.configs import registry
    from repro_torch.models.model import Model
    from repro_torch.serve import Engine, Request
    cfg = registry.get("llama3.2-1b").reduced().replace(dtype="float32")
    model = Model(cfg, device=cuda).init(0)
    outs = {}
    for paged in (False, True):
        for expandable in (False, True):
            eng = Engine(model, batch_slots=2, max_len=256, eos_id=-1,
                         paged=paged, expandable=expandable)
            for rid in range(3):
                eng.submit(Request(rid, (np.arange(20 + 60 * rid) * 3 + rid)
                                   .astype(np.int32) % cfg.vocab_size,
                                   max_new=40))
            eng.run()
            outs[paged, expandable] = {r.rid: tuple(r.out)
                                       for r in eng.finished}
            if expandable:
                assert eng.mgr.grows >= 2
    assert outs[False, True] == outs[False, False]
    assert outs[True, True] == outs[True, False]


PIPELINE_ON_THE_CARD = r"""
import sys
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def work(rank, world, store, out):
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    from repro_torch.sharding.pipeline import pipeline_apply
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    D = 256
    ws = torch.randn((world, D, D), generator=g, device=dev) / D ** 0.5
    x = torch.randn((16, D), generator=g, device=dev)
    stage = lambda w, h: torch.tanh(h @ w)
    for M in (2, 4, 8):
        got = pipeline_apply(stage, ws[rank], x, dist.group.WORLD, M)
        seq = []
        for mb in x.reshape(M, -1, D):
            for i in range(world):
                mb = stage(ws[i], mb)
            seq.append(mb)
        assert got.device == dev and torch.equal(got, torch.cat(seq)), M
    dist.destroy_process_group()
    print("PIPELINE_OK", rank, flush=True)


if __name__ == "__main__":
    store = sys.argv[1]
    mp.spawn(work, args=(2, store, None), nprocs=2)
"""


def test_pipeline_two_ranks_on_the_card(cuda, tmp_path):
    """Two gloo ranks on cuda:0, each one stage, activations through
    pinned host memory: the output equals the stages composed one
    microbatch at a time, bit for bit."""
    import os
    import subprocess
    import sys
    script = tmp_path / "pipeline_card.py"
    script.write_text(PIPELINE_ON_THE_CARD)
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    run = subprocess.run([sys.executable, str(script),
                          str(tmp_path / "store")], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert run.stdout.count("PIPELINE_OK") == 2


SHARDED_STEP_ON_THE_CARD = r"""
import sys
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

KW = dict(num_heads=4, num_kv_heads=2, head_dim=64, d_model=256, d_ff=512,
          dtype="float32")


def work(rank, world, store, sp):
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    from repro_torch.configs import registry
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import init_sharded
    from repro_torch.models import params as pm
    from repro_torch.models.model import Model
    from repro_torch.sharding import spmd
    from repro_torch.sharding.plan import make_plan
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.step import make_train_step
    dev = torch.device("cuda", 0)
    mesh = make_host_mesh(model=2)  # (data 1, model 2) over the two ranks
    cfg = registry.get("llama3.2-1b").reduced().replace(**KW)
    opt = make_optimizer(cfg)
    model = Model(cfg, plan=make_plan(cfg, mesh, sequence_parallel=sp))
    params, state = init_sharded(model, opt, 0)
    g = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (4, 129), device=dev,
                         generator=g)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    n0 = FA.flash_attention.launches
    loss, _, grads = make_train_step(model, opt, n_accum=2).grads(params,
                                                                  batch)
    launches = FA.flash_attention.launches - n0
    got = [spmd.full_tensor(x) for x in pm.tree_leaves(grads)]
    one = Model(cfg).init(0)
    want_loss, _, want = make_train_step(one, opt, n_accum=2).grads(
        one.weights(), batch)
    for a, b in zip(got, pm.tree_leaves(want)):
        err = float((a.double() - b.double()).abs().max()
                    / b.double().abs().max())
        assert err <= 1e-4, err
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * float(want_loss)
    assert launches == cfg.num_layers * 2, launches  # local heads, 2 mbs
    dist.destroy_process_group()
    print("SHARDED_OK", rank, flush=True)


if __name__ == "__main__":
    mp.spawn(work, args=(2, sys.argv[1], sys.argv[2] == "1"), nprocs=2)
"""


def _sharded_step_on_the_card(tmp_path, sp: bool):
    import os
    import subprocess
    import sys
    script = tmp_path / "sharded_card.py"
    script.write_text(SHARDED_STEP_ON_THE_CARD)
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    run = subprocess.run([sys.executable, str(script),
                          str(tmp_path / "store"), str(int(sp))], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert run.stdout.count("SHARDED_OK") == 2


def test_sharded_step_two_ranks_on_the_card(cuda, tmp_path):
    """Two gloo ranks on cuda:0 over a (data 1, model 2) mesh, reduced
    llama3.2-1b with heads of 64 (the flash kernel's), float32: the
    gradients of the sharded step, each rank's flash kernel on its two
    query heads and one kv head, equal the one-process step's within 1e-4
    of each leaf's largest magnitude."""
    _sharded_step_on_the_card(tmp_path, False)


def test_sharded_step_sequence_parallel_on_the_card(cuda, tmp_path):
    """The same step with sequence parallelism (the residual stream split
    along the sequence over the two ranks): the same gradients and flash
    launches."""
    _sharded_step_on_the_card(tmp_path, True)
