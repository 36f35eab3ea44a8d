"""The plain version of the fused multigrid solve (``thermal_mg``) on the CPU.

``thermal_mg_solve_ref`` against the JAX package's multigrid solve
(``repro.core.thermal.solve``, ``backend="jnp"`` as
``tests/test_thermal_multigrid.py`` runs it on the CPU) within
``PARITY_ATOL = 2e-2`` degC, the tolerance the reference holds between its
own tiers: on the grids of the FPGA paths at their paths' theta_JA (92x92
and 56x56 and 69x69 at 12, mcml's 152x152 at 2) and the odd 23x17 at both,
cold and warm. The 23x17 grid is a direct solve at the default 512 coarse
cells, so it runs with ``coarse_cells=64`` in both packages (two V-cycle
levels over odd edges). Plus batched == per-element bit for bit, the
(index, weight) prolongation and the halving-tree coarse product against
their dense float64 forms, the shared-memory plan, and that a CPU solve
launches nothing. One JAX compile per case: the file runs on one worker.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import thermal as JT
from repro_torch.core import thermal as TT
from repro_torch.kernels import thermal_mg as MG
from repro_torch.kernels import thermal_stencil as TS

PARITY_ATOL = 2e-2
CPU = torch.device("cpu")
H100_SMEM = 232_448  # bytes one block may opt into on the H100
# (m, n, theta_JA, coarse_cells): the paths' grids and the odd case
PATH_GRIDS = [(92, 92, 12.0, 512), (152, 152, 2.0, 512), (56, 56, 12.0, 512),
              (69, 69, 12.0, 512)]
CASES = PATH_GRIDS + [(23, 17, 2.0, 64), (23, 17, 12.0, 64)]


def _maps(cells: int):
    rng = np.random.default_rng(3)
    hot = np.zeros(cells)
    hot[cells // 2] = 500.0  # one 500 mW hot spot
    return np.stack([hot, rng.uniform(0.0, 5.0, cells), np.zeros(cells)])


def _problem(m, n, theta, cc, P, t_amb):
    """(b, plan, kwargs) as ``thermal.solve`` builds them."""
    tc = TT.ThermalConfig(theta_ja=theta, coarse_cells=cc)
    g_v, g_lat = TT.conductances(m, n, tc)
    plan = TT._plan_on(m, n, g_v, g_lat, cc, CPU)
    P = torch.as_tensor(P, dtype=torch.float32).reshape(-1, m, n) * 1e-3
    t = torch.as_tensor(t_amb, dtype=torch.float32).reshape(-1, 1, 1)
    kw = dict(tol=tc.tol, max_cycles=tc.max_cycles, n_smooth=tc.n_smooth)
    return P + g_v * t, plan, kw


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("m,n,theta,cc", CASES)
def test_plain_solve_matches_reference(m, n, theta, cc, warm):
    P = _maps(m * n)
    t_amb = np.array([25.0, 60.0, 85.0], np.float32)
    b, plan, kw = _problem(m, n, theta, cc, P, t_amb)
    assert len(plan.dims) >= 2  # a V-cycle hierarchy, not the direct tier
    T0 = np.full((3, m, n), 40.0, np.float32) if warm else None
    got, cycles = MG.thermal_mg_solve_ref(
        b, None if T0 is None else torch.as_tensor(T0), plan, **kw)
    assert got.shape == (3, m, n) and cycles.dtype == torch.int32
    jtc = JT.ThermalConfig(theta_ja=theta, coarse_cells=cc, backend="jnp")
    worst = 0.0
    for e in range(3):
        ref = np.asarray(JT.solve(
            jnp.asarray(P[e], jnp.float32), m, n, float(t_amb[e]), jtc,
            None if T0 is None else jnp.asarray(T0[e])))
        worst = max(worst, float(np.abs(got[e].numpy().reshape(-1)
                                        - ref).max()))
    assert worst <= PARITY_ATOL, f"{m}x{n} theta={theta}: {worst}"


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_batched_equals_per_element(warm):
    """Lockstep with frozen elements: batched == one at a time, T and
    cycle counts bit for bit. The warm batch mixes a converged field (0
    cycles), a start far from the solution and a zero power map."""
    m, n, theta, cc = 56, 56, 12.0, 512
    P = _maps(m * n)
    t_amb = np.array([25.0, 60.0, 85.0], np.float32)
    b, plan, kw = _problem(m, n, theta, cc, P, t_amb)
    T0 = None
    if warm:  # the uniform map from its converged field, the hot spot
        # from 60 C, the zero map from 40 C
        b = b[[1, 0, 2]]
        T0 = torch.cat([MG.thermal_mg_solve_ref(b[:1], None, plan, **kw)[0],
                        torch.full((2, m, n), 60.0)])
        T0[2] = 40.0
    T, cycles = MG.thermal_mg_solve_ref(b, T0, plan, **kw)
    for e in range(3):
        one, c = MG.thermal_mg_solve_ref(
            b[e:e + 1], None if T0 is None else T0[e:e + 1], plan, **kw)
        assert torch.equal(T[e], one[0]) and int(cycles[e]) == int(c[0])
    if warm:
        assert int(cycles[0]) == 0 and torch.equal(T[0], T0[0])
        assert int(cycles[1]) > 0 and int(cycles[2]) > 0


@pytest.mark.parametrize("m,n,theta,cc", CASES)
def test_prolongation_table_equals_dense(m, n, theta, cc):
    """The (index, weight) prolongation, rows then columns, equals
    Wr @ e @ Wc^T with the same float32 weights, in float64."""
    g_v, g_lat = TT.conductances(m, n, TT.ThermalConfig(theta_ja=theta))
    plan = TT._plan_on(m, n, g_v, g_lat, cc, CPU)
    rng = np.random.default_rng(7)
    for lvl, ((mm, nn), (mc, nc)) in enumerate(zip(plan.dims,
                                                    plan.dims[1:])):
        e = rng.standard_normal((2, mc, nc))
        table = tuple(x.double() if x.is_floating_point() else x
                      for x in plan.prolong[lvl])
        got = MG.prolong(torch.as_tensor(e), table).numpy()
        Wr = TT._interp_weights_np(mm, mc).astype(np.float32).astype(float)
        Wc = TT._interp_weights_np(nn, nc).astype(np.float32).astype(float)
        want = Wr @ e @ Wc.T
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("m,n,theta,cc", CASES)
def test_halving_tree_equals_dense_product(m, n, theta, cc):
    g_v, g_lat = TT.conductances(m, n, TT.ThermalConfig(theta_ja=theta))
    plan = TT._plan_on(m, n, g_v, g_lat, cc, CPU)
    mm, nn = plan.dims[-1]
    bc = np.random.default_rng(9).uniform(0.0, 1.0, (3, mm, nn))
    A = plan.a_inv.double()
    got = MG.coarse_solve(A, torch.as_tensor(bc)).numpy().reshape(3, -1)
    want = bc.reshape(3, -1) @ A.numpy().T
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_shared_memory_plan():
    """Every grid of the FPGA paths fits one H100 block's shared memory;
    256x256 does not (its fine T alone is 256 KB). The layout's T and
    right-hand-side offsets tile the buffer without overlap."""
    for m, n, theta, cc in PATH_GRIDS:
        g_v, g_lat = TT.conductances(m, n, TT.ThermalConfig(theta_ja=theta))
        plan = TT._plan_on(m, n, g_v, g_lat, cc, CPU)
        assert MG.plan_fits(plan.dims, H100_SMEM), (m, n)
        L, lanes, floats = (int(x) for x in plan.meta[:3])
        cells = [a * c for a, c in plan.dims]
        assert L == len(plan.dims) and lanes * 32 == MG.coarse_width(
            cells[-1])
        t_off = plan.meta[3 + 5 * MG.MAX_LEVELS:][:L]
        b_off = plan.meta[3 + 6 * MG.MAX_LEVELS:][1:L]
        spans = sorted([(int(o), c) for o, c in zip(t_off, cells)]
                       + [(int(o), c) for o, c in zip(b_off, cells[1:])])
        at = 0
        for o, c in spans:
            assert o == at
            at += c
        assert at + 32 == floats and 4 * floats == MG.smem_bytes(plan.dims)
    assert 50_000 < MG.smem_bytes(((92, 92), (46, 46), (23, 23),
                                   (12, 12))) < 60_000
    g_v, g_lat = TT.conductances(256, 256, TT.ThermalConfig(theta_ja=2.0))
    big = TT._plan_on(256, 256, g_v, g_lat, 512, CPU)
    assert not MG.plan_fits(big.dims, H100_SMEM)


def test_cpu_solve_launches_nothing():
    """On the CPU ``solve`` is the plain version (bit for bit) and neither
    kernel is launched; a CPU tensor handed to the wrapper takes the plain
    version too."""
    m = n = 56
    mg0, st0 = MG.thermal_mg_solve.launches, TS.thermal_stencil.launches
    composed = TT.solve.composed
    P = _maps(m * n)
    T = TT.solve(P, m, n, [25.0, 60.0, 85.0],
                 TT.ThermalConfig(theta_ja=12.0), device=CPU)
    b, plan, kw = _problem(m, n, 12.0, 512, P, [25.0, 60.0, 85.0])
    ref, _ = MG.thermal_mg_solve_ref(b, None, plan, **kw)
    assert torch.equal(T, ref.reshape(3, -1))
    via, cyc = MG.thermal_mg_solve(b, None, plan, **kw)
    assert torch.equal(via, ref) and cyc.shape == (3,)
    assert MG.thermal_mg_solve.launches == mg0
    assert TS.thermal_stencil.launches == st0
    assert TT.solve.composed == composed
