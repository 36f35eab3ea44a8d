"""The port's TPU-fleet substrate, planner, runtime and control plane
(``repro_torch.policy.TpuFleetSubstrate``, ``repro_torch.control``,
``repro_torch.core.runtime``) against the JAX package, on the CPU.

Inputs are the same on both sides (the reference's profile, knots, traces
and snapshots). Discrete outputs are held equal: the chosen rails of every
plan and of every RailField knot and chip, ``median_lut()`` against the
port's ``dynamic_lut`` (and the reference's), and, tick by tick, the
actions of the controller and the control loop (rails, sources, boosts,
rebalances, throttles), the replan reasons and the controller's counters.
Continuous outputs: ``GOLDEN_TPU`` within the reference's 1e-3
(``tests/test_policy_api.py``), the nominal-power grid and the settled
readouts within 1e-5 relative of the reference's.

The reference's ``test_control.py`` cases that need ``ft/monitor`` drive
their straggler events here through a scripted source of the same
``StragglerSample``\\ s (``MonitorTelemetry`` is ported with ``ft/monitor``).
"""
import numpy as np
import pytest

from repro import control as jctl
from repro.control.telemetry import _default_chip_of as j_chip_of
from repro.core import runtime as JRT
from repro.core import tpu_fleet as JTF
from repro_torch import control as ctl
from repro_torch import policy as pol
from repro_torch.control.telemetry import _default_chip_of
from repro_torch.core import runtime as RT
from repro_torch.core import tpu_fleet as TF

# tests/test_policy_api.py: EnergyAwareRuntime(profile).plan() @ 25C
GOLDEN_TPU = {
    "power_save": {"pod_power_w": 50196.734, "saving": 0.114950,
                   "step_s": 0.86, "t_max": 64.216},
    "min_energy": {"pod_power_w": 12895.854, "saving": 0.534707,
                   "step_s": 1.759880, "t_max": 35.075},
    "overscale:1.2": {"pod_power_w": 33512.879, "saving": 0.409113,
                      "step_s": 0.86, "t_max": 51.182},
}
# tests/test_railfield.py's knots
T_KNOTS = [10.0, 15.0, 20.0, 25.0, 30.0, 35.0, 40.0, 45.0]
U_KNOTS = [0.25, 0.5, 0.75, 1.0]
LUT_KNOTS = [10.0, 20.0, 30.0, 40.0, 50.0]  # tests/test_control.py
RTOL = 1e-5


def _prof(TFmod):
    return TFmod.StepProfile.from_roofline(compute_s=0.8, memory_s=0.45,
                                           collective_s=0.2)


@pytest.fixture(scope="module")
def jrt():
    return JRT.EnergyAwareRuntime(_prof(JTF), policy="power_save")


@pytest.fixture(scope="module")
def rt():
    return RT.EnergyAwareRuntime(_prof(TF), policy="power_save",
                                 device="cpu")


@pytest.fixture(scope="module")
def fields(jrt, rt):
    return (jrt.build_field(T_KNOTS, U_KNOTS),
            rt.build_field(T_KNOTS, U_KNOTS))


@pytest.fixture(scope="module")
def luts(jrt, rt):
    return jrt.build_lut(LUT_KNOTS), rt.build_lut(LUT_KNOTS)


def test_entry_points_default_to_the_card():
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RT.EnergyAwareRuntime(_prof(TF))


# ---------------------------------------------------------------------------
# the substrate, the planner, the runtime
# ---------------------------------------------------------------------------


def test_substrate_candidates_equal_the_reference(jrt, rt):
    js, ts = jrt.substrate, rt.substrate
    assert isinstance(ts, pol.TpuFleetSubstrate)
    assert (ts.grid, ts.n_domains, ts.n_candidates, ts.nominal_idx) == (
        js.grid, js.n_domains, js.n_candidates, js.nominal_idx)
    np.testing.assert_array_equal(ts.vc_np, np.asarray(js.vc_flat))
    np.testing.assert_array_equal(ts.vs_np, np.asarray(js.vs_flat))
    assert pol.tpu_substrate(_prof(TF), device="cpu") is ts


@pytest.mark.parametrize("spec", list(GOLDEN_TPU))
def test_plan_matches_golden_and_reference(spec):
    g = GOLDEN_TPU[spec]
    p = RT.EnergyAwareRuntime(_prof(TF), policy=spec, device="cpu").plan()
    assert p.pod_power_w == pytest.approx(g["pod_power_w"], rel=1e-3)
    assert p.saving == pytest.approx(g["saving"], abs=1e-3)
    assert p.step_s == pytest.approx(g["step_s"], rel=1e-3)
    assert p.t_max == pytest.approx(g["t_max"], abs=0.1)
    ref = JRT.EnergyAwareRuntime(_prof(JTF), policy=spec).plan()
    np.testing.assert_array_equal(p.v_core, ref.v_core)
    np.testing.assert_array_equal(p.v_sram, ref.v_sram)
    np.testing.assert_allclose(p.f_rel, ref.f_rel, rtol=RTOL)
    assert p.baseline_power_w == pytest.approx(ref.baseline_power_w,
                                               rel=RTOL)


def test_railfield_tables_equal_the_reference(fields):
    jf, tf = fields
    assert (tf.chips, tf.t.tolist(), tf.u.tolist()) == (
        jf.chips, jf.t.tolist(), jf.u.tolist())
    np.testing.assert_array_equal(tf.vc, jf.vc)  # every knot, every chip
    np.testing.assert_array_equal(tf.vs, jf.vs)
    np.testing.assert_allclose(tf.p_nom, jf.p_nom, rtol=RTOL)
    for t, u in ((12.5, 0.375), (27.5, 0.875), (42.5, 0.3), (60.0, 1.3)):
        for a, b in zip(tf.lookup(t, u), jf.lookup(t, u)):
            np.testing.assert_array_equal(a, b)


def test_median_lut_equals_dynamic_lut_exactly(jrt, rt, fields):
    jf, tf = fields
    legacy = rt.dynamic_lut(T_KNOTS)
    assert tf.median_lut().as_table() == legacy
    assert legacy == jrt.dynamic_lut(T_KNOTS)
    assert tf.median_lut().as_table() == jf.median_lut().as_table()


def test_early_freeze_decisions_equal_lockstep(rt):
    sub = rt.substrate
    solver = pol.cached_solver(sub, rt.policy_obj, rt.planner.delta_t,
                               rt.planner.max_iters)
    t = np.asarray([10.0, 21.0, 32.0, 43.0, 12.5, 44.0], np.float32)
    u = np.asarray([1.0, 0.5, 0.75, 1.0, 0.25, 0.6], np.float32)
    envs = {"t_amb": t, "util": u[:, None] * np.ones((1, sub.n_domains),
                                                      np.float32),
            "gamma": np.ones(t.size, np.float32)}
    lock = solver.solve_batch(envs)
    frozen = solver.solve_batch(envs, early_freeze=True)
    assert lock.n_iters.max() > lock.n_iters.min()
    for name in ("idx", "n_iters", "converged", "idx_hist"):
        np.testing.assert_array_equal(getattr(lock, name),
                                      getattr(frozen, name))


def test_baseline_cache_counts_like_the_reference():
    counts = []
    for mod, tfm, kw in ((RT, TF, {"device": "cpu"}), (JRT, JTF, {})):
        r = mod.EnergyAwareRuntime(_prof(tfm), policy="power_save", **kw)
        n = []
        r.plan()
        r.plan()
        n.append(r.planner.baseline_solves)
        r.t_amb = 31.0
        r.plan()
        n.append(r.planner.baseline_solves)
        util = np.ones(r.m * r.n, np.float32)
        util[:8] = 0.5
        r.plan(util_scale=util)
        n.append(r.planner.baseline_solves)
        counts.append(n)
    assert counts[0] == counts[1] == [1, 2, 3]


def test_baseline_prefill_hits_at_grid_knots():
    rt2 = RT.EnergyAwareRuntime(_prof(TF), device="cpu")
    t_knots = ctl.sweep_points(10.0, 45.0, 7)
    rt2.build_field(t_knots, [0.5, 1.0])
    for t in t_knots:
        rt2.planner.baseline_power(rt2.planner.env(t))
    assert rt2.planner.baseline_solves == 0
    rt2.planner.baseline_power(rt2.planner.env(26.2))
    assert rt2.planner.baseline_solves == 1


@pytest.mark.parametrize("T_chip", [60.0, 94.5])
def test_straggler_mitigation_equals_the_reference(jrt, rt, T_chip):
    plan, jplan = rt.planner.plan_at(25.0)[0], jrt.planner.plan_at(25.0)[0]
    got = rt.planner.mitigate(plan, 7, T_chip)
    want = jrt.planner.mitigate(jplan, 7, T_chip)
    assert got["action"] == want["action"]
    if "extra_power_w" in want:
        assert got["extra_power_w"] == pytest.approx(want["extra_power_w"],
                                                      rel=RTOL)


# ---------------------------------------------------------------------------
# DynamicLut, telemetry
# ---------------------------------------------------------------------------


def test_dynamic_lut_equals_the_reference(luts):
    jl, tl = luts
    assert tl.as_table() == jl.as_table()
    for t in (-5.0, 15.0, 25.0, 35.0, 45.0, 90.0):
        assert tl.lookup(t) == jl.lookup(t)
    vc, vs = tl.lookup(np.asarray([15.0, 25.0]))
    assert vc.shape == vs.shape == (2,)
    assert tl.covers(30.0) and not tl.covers(55.0)
    assert tl.covers(52.0, margin=2.0)
    with pytest.raises(ValueError):
        ctl.DynamicLut({})


def test_railfield_validation():
    with pytest.raises(ValueError):
        ctl.RailField([10.0], [], np.zeros((1, 0, 4)), np.zeros((1, 0, 4)))
    with pytest.raises(ValueError):
        ctl.RailField([10.0, 20.0], [1.0], np.zeros((1, 1, 4)),
                      np.zeros((1, 1, 4)))


def test_default_chip_of_equals_the_reference():
    for name in ("worker7", "host1-worker7", "tpu-v4-rank12", "coordinator"):
        assert _default_chip_of(name) == j_chip_of(name)


def test_telemetry_bus_equals_the_reference():
    def run(mod):
        class OneShot:
            fired = False

            def poll(self, now):
                if self.fired:
                    return []
                self.fired = True
                return [mod.AmbientSample(30.0),
                        mod.StragglerSample("w1", 3, 2.0, 1),
                        mod.TickSample(0, 3, 2, 0, 5, 0.1, slots=4,
                                       pages_free=7),
                        mod.AmbientSample(99.0)]  # out of range: quarantined

        bus = mod.TelemetryBus([OneShot()])
        s1, s2 = bus.poll(0.0), bus.poll(1.0)
        return [(s.t_amb, len(s.stragglers), s.queued, s.active, s.tokens,
                 s.slots, s.pages_free, s.load, s.quarantined, s.t_amb_age)
                for s in (s1, s2)]

    assert run(ctl) == run(jctl)


# ---------------------------------------------------------------------------
# the controller and the loop, tick by tick
# ---------------------------------------------------------------------------


def _actions(acts):
    """Actions as comparable tuples (rails as float32 arrays' bytes)."""
    out = []
    for a in acts:
        if isinstance(a, (ctl.SetRails, jctl.SetRails)):
            out.append(("SetRails", a.source,
                        np.asarray(a.v_core, np.float32).tobytes(),
                        np.asarray(a.v_sram, np.float32).tobytes()))
        elif isinstance(a, (ctl.BoostRail, jctl.BoostRail)):
            out.append(("BoostRail", a.chip, a.v_core, a.v_sram))
        else:
            out.append((type(a).__name__,) + tuple(
                v for k, v in sorted(vars(a).items()) if k != "plan"))
    return out


def _stats(c):
    s = c.stats
    return (s.lut_hits, s.replans, s.boosts, s.rebalances, s.throttles,
            s.unmapped, s.replan_reasons, s.below_axis_clamps)


class Straggle:
    """Scripted straggler events: {tick: [(worker, step, ratio, chip)]}."""

    def __init__(self, mod, events):
        self.mod, self.events = mod, events

    def poll(self, now):
        return [self.mod.StragglerSample(*e)
                for e in self.events.get(int(now), ())]


class FakeEngine:
    admit_cap = None


def _run_day(mod, runtime, table, trace, ticks, ctrl_kw, extra=(),
             temps=None, util=None, engine=False):
    """One control day on ``mod``'s package: per tick (actions, readout
    numbers, admit cap), and the controller."""
    kw = dict(ctrl_kw)
    kw["lut" if isinstance(table, (ctl.DynamicLut, jctl.DynamicLut))
       else "field"] = table
    controller = runtime.controller(**kw)
    fleet = mod.FleetActuator.from_runtime(runtime)
    eng = FakeEngine()
    bus = mod.TelemetryBus([mod.AmbientSensor(trace), *extra, fleet])
    acts = [fleet] + ([mod.EngineActuator(eng)] if engine else [])
    loop = mod.ControlLoop(bus, controller, acts)
    out = []
    for k in range(ticks):
        if temps and k in temps:
            chips, t = temps[k]
            if mod is ctl:
                fleet.set_temps(chips, t)
            else:
                fleet.T = np.asarray(fleet.T).copy()
                fleet.T[chips] = t
        rep = loop.step(now=float(k),
                        util=None if util is None else util(k))
        r = rep.readout
        out.append((_actions(rep.actions), eng.admit_cap,
                    (r.pod_power_w, r.nominal_power_w, r.t_mean, r.t_max)))
    return out, controller, fleet


def _hold_days(got, want):
    assert len(got) == len(want)
    for k, ((ga, gc, gr), (wa, wc, wr)) in enumerate(zip(got, want)):
        assert ga == wa, f"tick {k}: actions differ"
        assert gc == wc, f"tick {k}: admit cap differs"
        np.testing.assert_allclose(gr, wr, rtol=RTOL,
                                   err_msg=f"tick {k}: readout")


DAYS = {
    # tests/test_control.py::TestClosedLoop
    "diurnal": (lambda now: 25.0 + 10.0 * np.sin(2 * np.pi * now / 24.0),
                24, {"guard_band_c": 3.0}),
    "ambient_jump": (lambda now: 22.0 if now < 3 else 34.0, 6,
                     {"guard_band_c": 2.0}),
    "out_of_range": (52.0, 2, {"guard_band_c": 1.0}),
}


@pytest.mark.parametrize("table", ["lut", "field"])
@pytest.mark.parametrize("day", list(DAYS))
def test_loop_day_equals_the_reference(jrt, rt, luts, fields, day, table):
    trace, ticks, kw = DAYS[day]
    jt, tt = luts if table == "lut" else fields
    got, c, _ = _run_day(ctl, rt, tt, trace, ticks, kw)
    want, jc, _ = _run_day(jctl, jrt, jt, trace, ticks, kw)
    _hold_days(got, want)
    assert _stats(c) == _stats(jc)
    if day == "ambient_jump" and table == "lut":
        assert c.stats.replans == 2 and c.stats.lut_hits == 4
    if day == "out_of_range" and table == "lut":
        assert any(r.startswith("lut_range")
                   for r in c.stats.replan_reasons[1:])
    if day == "diurnal":
        t_max = [r[3] for _, _, r in got]
        assert max(t_max) < TF.T_MAX_CHIP
        assert c.stats.lut_hits > c.stats.replans >= 1


def test_straggler_boost_then_rebalance_equals_the_reference(jrt, rt,
                                                             luts):
    events = {1: [("worker7", 4, 1.9, 7)], 2: [("worker7", 5, 2.2, 7)]}
    temps = {2: (7, 94.5)}  # chip so hot even nominal rails can't hold f
    kw = {"guard_band_c": 2.0}
    got, c, fleet = _run_day(ctl, rt, luts[1], 25.0, 3, kw,
                             extra=[Straggle(ctl, events)], temps=temps)
    want, jc, _ = _run_day(jctl, jrt, luts[0], 25.0, 3, kw,
                           extra=[Straggle(jctl, events)], temps=temps)
    _hold_days(got, want)
    assert _stats(c) == _stats(jc)
    assert [a[0] for a in got[1][0]] == ["SetRails", "BoostRail"]
    # the hot chip also crowds the junction limit: the admission throttle
    # rides the same tick
    assert [a[0] for a in got[2][0]] == ["SetRails", "Rebalance", "Throttle"]
    assert c.stats.boosts == c.stats.rebalances == 1
    assert 7 not in fleet.boosted


def test_thermal_pressure_throttles_then_lifts_equals_the_reference(
        jrt, rt, luts):
    kw = {"guard_band_c": 50.0, "t_headroom_c": 5.0}
    chips = rt.substrate.n_domains
    cool = np.full(chips, 40.0, np.float32)
    temps = {1: (slice(None), TF.T_MAX_CHIP - 1.0), 2: (slice(None), cool)}
    got, c, _ = _run_day(ctl, rt, luts[1], 25.0, 4, kw, temps=temps,
                         engine=True)
    want, jc, _ = _run_day(jctl, jrt, luts[0], 25.0, 4, kw, temps=temps,
                           engine=True)
    _hold_days(got, want)
    assert _stats(c) == _stats(jc)
    caps = [cap for _, cap, _ in got]
    assert caps[1] == c.throttle_cap and caps[-1] is None
    assert any(r.startswith("thermal_emergency")
               for r in c.stats.replan_reasons)


@pytest.mark.parametrize("case", ["load_swing", "util_past_axis",
                                  "snapshot_load", "unmapped", "migrated"])
def test_field_controller_decisions_equal_the_reference(jrt, rt, fields,
                                                        case):
    """tests/test_railfield.py::TestFieldController and the unmapped-chip
    case of tests/test_control.py, decision by decision."""
    chips = rt.substrate.n_domains

    def decisions(mod, runtime, field):
        kw = {"field": field, "guard_band_c": 3.0}
        if case == "util_past_axis":
            kw["util_band"] = 0.1
        c = runtime.controller(**kw)
        S = mod.Snapshot
        if case == "load_swing":
            seq = [(S(t_amb=25.0), None),
                   (S(t_amb=25.0), np.ones(chips, np.float32)),
                   (S(t_amb=25.0), np.full(chips, 0.45, np.float32))]
        elif case == "util_past_axis":
            seq = [(S(t_amb=25.0), None),
                   (S(t_amb=25.0), np.full(chips, 1.3, np.float32))]
        elif case == "snapshot_load":
            seq = [(S(t_amb=25.0), None),
                   (S(t_amb=25.0, active=64, slots=64), None),
                   (S(t_amb=25.0, active=16, slots=64), None)]
        elif case == "unmapped":
            seq = [(S(t_amb=25.0, stragglers=[
                mod.StragglerSample("w", 0, 2.0, chip=999)]), None)]
        else:
            shares = np.ones(chips, np.float32)
            shares[5] = 0.0
            seq = [(S(t_amb=25.0, shares=shares, stragglers=[
                mod.StragglerSample("worker5", 0, 2.0, chip=5)]), None)]
        return [_actions(c.decide(s, util=u)) for s, u in seq], _stats(c)

    got, gs = decisions(ctl, rt, fields[1])
    want, ws = decisions(jctl, jrt, fields[0])
    assert got == want and gs == ws
    if case == "load_swing":
        assert gs[:2] == (2, 1)  # lut hits, replans: only the cold start
    if case == "util_past_axis":
        assert any(r.startswith("util_range") for r in gs[6])
    if case == "unmapped":
        assert gs[5] == 1


def test_boosts_survive_field_rewrites_per_chip(rt):
    fleet = ctl.FleetActuator.from_runtime(rt)
    chips = rt.substrate.n_domains
    fleet.apply(ctl.BoostRail(3, 0.73, 0.83, 1.0))
    fleet.apply(ctl.BoostRail(9, TF.V_CORE_NOM, TF.V_SRAM_NOM, 1.0))
    vc = np.full(chips, 0.60, np.float32)
    vs = np.full(chips, 0.70, np.float32)
    fleet.apply(ctl.SetRails(vc, vs, source="lut"))
    assert fleet.v_core[3] == pytest.approx(0.73)
    assert fleet.v_sram[3] == pytest.approx(0.83)
    assert fleet.v_core[9] == pytest.approx(TF.V_CORE_NOM)
    assert fleet.v_core[4] == pytest.approx(0.60)
    fleet.apply(ctl.Rebalance(3, "too hot"))
    fleet.apply(ctl.SetRails(vc, vs, source="lut"))
    assert fleet.v_core[3] == pytest.approx(0.60)
    assert fleet.v_core[9] == pytest.approx(TF.V_CORE_NOM)


def test_nominal_power_and_settle_equal_the_reference(jrt, rt, fields):
    """Below the utilization axis the actuator falls back to the exact
    nominal solve, inside it reads the field; the standalone fallback (no
    planner) and one settle's readout equal the reference's."""
    jf, tf = fields
    us_lo = np.full(tf.chips, 0.1, np.float32)
    us_in = np.full(tf.chips, 0.8, np.float32)
    fleet = ctl.FleetActuator.from_runtime(rt, field=tf)
    jfleet = jctl.FleetActuator.from_runtime(jrt, field=jf)
    for us in (us_lo, us_in):
        assert fleet._nominal_power(25.0, us) == pytest.approx(
            jfleet._nominal_power(25.0, us), rel=RTOL)
    alone = ctl.FleetActuator(rt.substrate, rt.prof, rt.lib)
    jalone = jctl.FleetActuator(jrt.substrate, jrt.prof, jrt.lib)
    assert alone._nominal_power(30.0, us_in) == pytest.approx(
        jalone._nominal_power(30.0, us_in), rel=RTOL)
    snap = ctl.Snapshot(t_amb=30.0, active=3, slots=4)
    jsnap = jctl.Snapshot(t_amb=30.0, active=3, slots=4)
    alone._nominal_power(30.0, snap.util(tf.chips))  # cached from here
    syncs = alone.host_syncs
    r, jr = alone.settle(snap), jalone.settle(jsnap)
    assert alone.host_syncs == syncs + 1  # one read of field and powers
    np.testing.assert_allclose(
        [r.pod_power_w, r.nominal_power_w, r.t_mean, r.t_max],
        [jr.pod_power_w, jr.nominal_power_w, jr.t_mean, jr.t_max],
        rtol=RTOL)
    assert r.saving == pytest.approx(jr.saving, abs=RTOL)  # 1 - a ratio
    np.testing.assert_allclose(alone.t_chip, np.asarray(jalone.T), rtol=RTOL)
