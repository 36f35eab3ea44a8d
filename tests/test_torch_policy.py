"""The port's policy stack against the JAX package's.

Policies: the same (delay, power) arrays through both packages' policy math
(float32, 1e-6 relative). Solver: the discrete decisions (chosen candidate,
iteration count, convergence flag, per-iteration choice history) must be
equal, on or1200 (26x26, whose thermal solve runs the multigrid smoother)
and mkPktMerge (8x8, the direct coarse solve). ``solve_batch``, lockstep and
``early_freeze``, must decide as the sequential solves do.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import policy as jpol
from repro.core import thermal as JT
from repro.core import vtr_benchmarks as jvb
from repro.core.voltage_scaling import REFINE_WINDOW_V
from repro_torch import policy as tpol
from repro_torch.core import thermal as TT
from repro_torch.core import vtr_benchmarks as tvb

DECISIONS = ("idx", "n_iters", "converged", "idx_hist")
POLICIES = {
    "power_save": (jpol.PowerSave(), tpol.PowerSave()),
    "min_energy": (jpol.MinEnergy(), tpol.MinEnergy()),
    "overscale": (jpol.Overscale(gamma=1.2), tpol.Overscale(gamma=1.2)),
    "error_tolerant": (jpol.ErrorTolerant(budget=1e-5),
                       tpol.ErrorTolerant(budget=1e-5)),
}


class _Sub:
    """The substrate fields the policies read."""
    d_worst = 6.25
    f_nom = 1.0 / 6.25
    f_cap = np.inf

    def __init__(self, xp):
        self.xp = xp

    def exec_time(self, f):
        return 1.0 / f


@pytest.mark.parametrize("name", list(POLICIES))
def test_policy_math_matches_reference(name):
    jp, tp = POLICIES[name]
    rng = np.random.default_rng(4)
    d = rng.uniform(4.0, 9.0, (3, 1, 50)).astype(np.float32)
    p = rng.uniform(1.0, 100.0, (3, 1, 50)).astype(np.float32)
    jd, td = jnp.asarray(d), torch.as_tensor(d)
    js, ts = _Sub(jnp), _Sub(torch)
    jf, tf = jp.frequency(js, jd, {}), tp.frequency(ts, td, {})
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6)
    np.testing.assert_array_equal(tp.feasible(ts, td, {}).numpy(),
                                  np.asarray(jp.feasible(js, jd, {})))
    np.testing.assert_allclose(
        tp.objective(ts, td, torch.as_tensor(p), tf, {}).numpy(),
        np.asarray(jp.objective(js, jd, jnp.asarray(p), jf, {})), rtol=1e-6)
    assert (tp.metric, tp.nominal_fallback) == (jp.metric, jp.nominal_fallback)


def test_env_gamma_and_budget_broadcast():
    d = torch.tensor([[[6.0, 7.0, 8.0]], [[6.0, 7.0, 8.0]]])
    env = {"gamma": torch.tensor([1.0, 1.2]).reshape(2, 1, 1)}
    feas = tpol.Overscale().feasible(_Sub(torch), d, env)
    assert feas.tolist() == [[[True, False, False]], [[True, True, False]]]


def test_sdc_model_matches_reference():
    x = np.linspace(-0.1, 0.3, 17).astype(np.float32)
    np.testing.assert_allclose(
        tpol.escaped_sdc_rate(torch.as_tensor(x)).numpy(),
        np.asarray(jpol.escaped_sdc_rate(jnp.asarray(x))), rtol=1e-6)
    b = np.array([0.0, 1e-7, 1e-5, 1e-3], np.float32)
    np.testing.assert_allclose(
        tpol.overshoot_budget(torch.as_tensor(b)).numpy(),
        np.asarray(jpol.overshoot_budget(jnp.asarray(b))), rtol=1e-6)


def test_from_spec():
    assert isinstance(tpol.from_spec("power_save"), tpol.PowerSave)
    assert isinstance(tpol.from_spec("min_energy"), tpol.MinEnergy)
    ov = tpol.from_spec("overscale:1.35")
    assert isinstance(ov, tpol.Overscale) and ov.gamma == pytest.approx(1.35)
    et = tpol.from_spec("error_tolerant:1e-5")
    assert isinstance(et, tpol.ErrorTolerant) and et.budget == 1e-5
    assert tpol.from_spec(ov) is ov
    for bad in ("warp_speed", "overscale:x", "error_tolerant:y"):
        with pytest.raises(ValueError):
            tpol.from_spec(bad)


def _solvers(name, theta, policy, window, delta_t=0.1):
    jsub = jpol.fpga_substrate(jvb.load(name),
                               tc=JT.ThermalConfig(theta_ja=theta))
    tsub = tpol.fpga_substrate(tvb.load(name),
                               tc=TT.ThermalConfig(theta_ja=theta),
                               device="cpu")
    jp, tp = POLICIES[policy]
    return (jpol.cached_solver(jsub, jp, delta_t, 10, refine_window=window),
            tpol.cached_solver(tsub, tp, delta_t, 10, refine_window=window))


@pytest.mark.parametrize("name,theta,policy,window", [
    ("or1200", 12.0, "power_save", REFINE_WINDOW_V),
    ("or1200", 2.0, "min_energy", None),
    ("mkPktMerge", 12.0, "power_save", REFINE_WINDOW_V),
    ("mkPktMerge", 2.0, "overscale", None),
])
def test_solve_decisions_match_reference(name, theta, policy, window):
    js, ts = _solvers(name, theta, policy, window)
    env = {"t_amb": 60.0, "act": 1.0}
    ref, got = js.solve(env), ts.solve(env)
    for k in DECISIONS:
        np.testing.assert_array_equal(got._asdict()[k],
                                      np.asarray(ref._asdict()[k]), err_msg=k)
    n = int(got.n_iters)
    np.testing.assert_allclose(got.p_hist[:n], ref.p_hist[:n], rtol=1e-3)
    np.testing.assert_allclose(got.T, ref.T, atol=2e-2)
    np.testing.assert_allclose(got.p_final, ref.p_final, rtol=1e-3)


T_AMBS = np.array([0.0, 20.0, 40.0, 60.0, 80.0, 85.0], np.float32)
ACTS = np.array([0.1, 0.3, 1.0, 0.6, 1.0, 0.2], np.float32)


@pytest.fixture(scope="module")
def pkt_batch():
    """mkPktMerge at six (ambient, activity) pairs whose fixed points take
    1 or 2 iterations: lockstep, early-freeze, sequential, the reference."""
    js, ts = _solvers("mkPktMerge", 12.0, "power_save", REFINE_WINDOW_V)
    envs = {"t_amb": T_AMBS, "act": ACTS}
    return {
        "lockstep": ts.solve_batch(envs),
        "freeze": ts.solve_batch(envs, early_freeze=True, segment=1),
        "seq": [ts.solve({"t_amb": float(t), "act": float(a)})
                for t, a in zip(T_AMBS, ACTS)],
        "ref": js.solve_batch(envs),
    }


@pytest.mark.parametrize("mode", ["lockstep", "freeze"])
def test_solve_batch_equals_sequential(pkt_batch, mode):
    sol = pkt_batch[mode]
    assert len(set(sol.n_iters.tolist())) > 1  # elements stop apart
    for i, one in enumerate(pkt_batch["seq"]):
        for k in DECISIONS:
            np.testing.assert_array_equal(sol._asdict()[k][i],
                                          one._asdict()[k], err_msg=k)
        np.testing.assert_allclose(sol.T[i], one.T, atol=1e-4)


def test_solve_batch_matches_reference(pkt_batch):
    for k in DECISIONS:
        np.testing.assert_array_equal(pkt_batch["lockstep"]._asdict()[k],
                                      np.asarray(pkt_batch["ref"]._asdict()[k]),
                                      err_msg=k)


def test_early_freeze_on_the_smoother_path():
    """or1200 (multigrid smoother) where elements need 2 or 3 iterations:
    early-freeze and lockstep decide as the reference's batch does."""
    js, ts = _solvers("or1200", 12.0, "power_save", REFINE_WINDOW_V, 0.01)
    envs = {"t_amb": T_AMBS, "act": ACTS}
    a = ts.solve_batch(envs)
    b = ts.solve_batch(envs, early_freeze=True, segment=1)
    ref = js.solve_batch(envs)
    assert len(set(a.n_iters.tolist())) > 1
    for k in DECISIONS:
        np.testing.assert_array_equal(a._asdict()[k], b._asdict()[k])
        np.testing.assert_array_equal(a._asdict()[k],
                                      np.asarray(ref._asdict()[k]))


def test_candidate_search_matches_reference(monkeypatch):
    """cand_delay / cand_power over all 1066 candidates at two fields equal
    the reference's (1e-5 relative), and the chunking of the candidate
    axis does not change a single value."""
    from repro_torch.policy import substrate as TS
    nl, tc = tvb.load("or1200"), TT.ThermalConfig(theta_ja=12.0)
    tsub = tpol.fpga_substrate(nl, tc=tc, device="cpu")
    jsub = jpol.fpga_substrate(jvb.load("or1200"),
                               tc=JT.ThermalConfig(theta_ja=12.0))
    rng = np.random.default_rng(6)
    T = rng.uniform(40.0, 90.0, (2, nl.n_tiles)).astype(np.float32)
    env = {"t_amb": torch.tensor([40.0, 60.0]), "act": torch.tensor([0.5, 1.0])}
    f = torch.full((2, 1, tsub.n_candidates), tsub.f_nom)
    d = tsub.cand_delay(torch.as_tensor(T), env)
    p = tsub.cand_power(torch.as_tensor(T), f, env)
    for b in range(2):
        jenv = {"t_amb": jnp.float32(env["t_amb"][b]),
                "act": jnp.float32(env["act"][b])}
        np.testing.assert_allclose(
            d[b].numpy(), np.asarray(jsub.cand_delay(jnp.asarray(T[b]), jenv)),
            rtol=1e-5)
        np.testing.assert_allclose(
            p[b].numpy(), np.asarray(jsub.cand_power(
                jnp.asarray(T[b]), jnp.float32(jsub.f_nom), jenv)), rtol=1e-5)
    monkeypatch.setitem(TS.CHUNK_ELEMS, "cpu", 1 << 18)  # many chunks
    assert torch.equal(tsub.cand_delay(torch.as_tensor(T), env), d)
    assert torch.equal(tsub.cand_power(torch.as_tensor(T), f, env), p)


def test_batch_env_validation():
    _, ts = _solvers("mkPktMerge", 2.0, "power_save", None)
    with pytest.raises(ValueError):
        ts.solve_batch({"t_amb": np.zeros(3), "act": np.ones(2)})


def test_substrate_protocol_and_cache():
    nl = tvb.load("mkPktMerge")
    tc = TT.ThermalConfig(theta_ja=12.0)
    sub = tpol.fpga_substrate(nl, tc=tc, device="cpu")
    assert isinstance(sub, tpol.Substrate)
    assert tpol.fpga_substrate(nl, tc=tc, device="cpu") is sub
    assert sub.nominal_only().d_worst == sub.d_worst
    assert 0 <= sub.nominal_idx < sub.n_candidates == 26 * 41
    jsub = jpol.fpga_substrate(jvb.load("mkPktMerge"), tc=JT.ThermalConfig(
        theta_ja=12.0))
    assert sub.d_worst == pytest.approx(jsub.d_worst, rel=1e-6)
    assert sub.nominal_idx == jsub.nominal_idx
    assert tpol.Solver(sub, tpol.PowerSave(), max_iters=0).max_iters == 1
