"""The port's thermal solver against the JAX package's.

Both tiers on the cases ``tests/test_thermal_multigrid.py`` pins (1x1, odd
sizes, the 92x92 Table-II die; theta_JA 2 and 12; zero, hot-spot and
uniform power), within ``PARITY_ATOL = 2e-2`` degC, the tolerance the
reference holds between its own tiers (a failure reports the largest
difference). Plus warm starts, the 256x256 energy balance, and a batched
solve against per-element solves.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import thermal as JT
from repro_torch import resolve_device
from repro_torch.core import thermal as TT

PARITY_ATOL = 2e-2
CPU = "cpu"


def _power_maps(cells: int):
    rng = np.random.default_rng(3)
    hot = np.zeros(cells)
    hot[cells // 2] = 500.0  # one 500 mW hot spot
    return {"zero": np.zeros(cells), "hotspot": hot,
            "uniform": rng.uniform(0.0, 5.0, cells)}


@pytest.mark.parametrize("solver", ["multigrid", "jacobi"])
@pytest.mark.parametrize("m,n", [(1, 1), (3, 5), (23, 17), (92, 92)])
@pytest.mark.parametrize("theta", [2.0, 12.0])
def test_solve_matches_reference(solver, m, n, theta):
    worst = 0.0
    for name, P in _power_maps(m * n).items():
        ref = np.asarray(JT.solve(jnp.asarray(P, jnp.float32), m, n, 25.0,
                                  JT.ThermalConfig(theta_ja=theta,
                                                   solver=solver)))
        got = TT.solve(P, m, n, 25.0,
                       TT.ThermalConfig(theta_ja=theta, solver=solver),
                       device=CPU).numpy()
        assert got.shape == (m * n,)
        worst = max(worst, float(np.abs(got - ref).max()))
    assert worst <= PARITY_ATOL, f"{m}x{n} theta={theta}: {worst}"


def test_warm_start_matches_reference():
    m = 23
    P = _power_maps(m * m)["uniform"]
    T0 = np.full((m * m,), 40.0, np.float32)
    ref = np.asarray(JT.solve(jnp.asarray(P, jnp.float32), m, m, 25.0,
                              JT.ThermalConfig(theta_ja=12.0),
                              jnp.asarray(T0)))
    got = TT.solve(P, m, m, 25.0, TT.ThermalConfig(theta_ja=12.0), T0,
                   device=CPU).numpy()
    np.testing.assert_allclose(got, ref, atol=PARITY_ATOL)


@pytest.mark.parametrize("offset", [-30.0, 0.0, 25.0, 60.0])
def test_converged_field_invariant_to_T0(offset):
    m = 23
    tc = TT.ThermalConfig(theta_ja=12.0)
    P = _power_maps(m * m)["uniform"]
    T_default = TT.solve(P, m, m, 25.0, tc, device=CPU)
    T_warm = TT.solve(P, m, m, 25.0, tc,
                      torch.full((m * m,), 25.0 + offset), device=CPU)
    np.testing.assert_allclose(T_warm.numpy(), T_default.numpy(), atol=5e-3)


def test_warm_start_from_converged_is_noop():
    m = 32
    tc = TT.ThermalConfig(theta_ja=2.0)
    P = _power_maps(m * m)["hotspot"]
    T1 = TT.solve(P, m, m, 25.0, tc, device=CPU)
    syncs = TT.solve.host_syncs
    T2 = TT.solve(P, m, m, 25.0, tc, T1, device=CPU)
    assert torch.equal(T1, T2)
    assert TT.solve.host_syncs == syncs + 1  # one stop test, zero cycles


def test_accepts_2d_T0():
    T = TT.solve(np.zeros(35), 5, 7, 25.0, TT.ThermalConfig(theta_ja=2.0),
                 torch.full((5, 7), 40.0), device=CPU)
    np.testing.assert_allclose(T.numpy(), 25.0, atol=1e-3)


def test_256x256_energy_balance():
    """All heat exits through G_v: the mean rise equals theta_JA * P."""
    m = 256
    rng = np.random.default_rng(5)
    P = rng.uniform(0.0, 1.0, (m * m,)).astype(np.float32)
    T = TT.solve(P, m, m, 25.0, TT.ThermalConfig(theta_ja=2.0),
                 device=CPU).numpy()
    rise = float(T.mean() - 25.0)
    assert rise == pytest.approx(2.0 * float(P.sum()) * 1e-3, rel=1e-3)


@pytest.mark.parametrize("solver", ["multigrid", "jacobi"])
@pytest.mark.parametrize("warm", [False, True])
def test_batched_solve_equals_per_element(solver, warm):
    """Elements stop on their own tests: batched == one at a time."""
    m, n = 23, 17
    tc = TT.ThermalConfig(theta_ja=12.0, solver=solver)
    maps = _power_maps(m * n)
    P = np.stack([maps["hotspot"], maps["uniform"], maps["zero"]])
    t_amb = np.array([25.0, 60.0, 85.0], np.float32)
    T0 = (np.stack([np.full(m * n, t) for t in (30.0, 70.0, 85.0)])
          if warm else None)
    batched = TT.solve(P, m, n, t_amb, tc, T0, device=CPU)
    assert batched.shape == (3, m * n)
    for b in range(3):
        one = TT.solve(P[b], m, n, float(t_amb[b]), tc,
                       None if T0 is None else T0[b], device=CPU)
        assert torch.equal(batched[b], one)


def test_unknown_solver_raises():
    with pytest.raises(ValueError):
        TT.solve(np.zeros(4), 2, 2, 25.0, TT.ThermalConfig(solver="warp"),
                 device=CPU)


def test_no_card_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        TT.solve(np.zeros(4), 2, 2, 25.0)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
