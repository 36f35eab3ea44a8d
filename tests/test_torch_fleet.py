"""The port's §10 fleet tier (``repro_torch.control.fleet``: the pod rail
channels, the planner facade over one shared solve, the telemetry fan-out,
the health machine; ``repro_torch.scenarios.fleet_replay``) against the JAX
package, on the CPU.

The cases of ``tests/test_fleet.py`` fed to both packages, at the
reference's test knots (ambient sweep ``(15, 40, 4)``, util knots
``(0.25, 1, 3)``). Equal means equal: the applied rails, the replan count
and reasons, boosts, rebalances, the condemned chips and the shares, the
fleet's health ``events`` and ``state_trace``, quarantines, restores and
migrations, and the summed §9 ledger of the pod controllers.
``mean_saving``, ``energy_j`` and ``t_max`` agree within 1e-3 relative.
Within the port: a 1-pod ``FleetLoop`` is the flat ``ControlLoop``
fingerprint for fingerprint, and a clean day gives the same rails, energy
and condemned set at 1, 2 and 4 pods (pod-count invariance).
"""
import numpy as np
import pytest

from repro import control as jctl
from repro import scenarios as jsc
from repro.core import runtime as JRT
from repro.core import tpu_fleet as JTF
from repro_torch import control as ctl
from repro_torch import scenarios as sc
from repro_torch.core import runtime as RT
from repro_torch.core import tpu_fleet as TF
from test_torch_faults import one_thread  # noqa: F401

SW = (15.0, 40.0, 4)  # tests/test_fleet.py's coarse knots
US = (0.25, 1.0, 3)
REL = 1e-3
MODS = {"jax": jctl, "torch": ctl}
SMODS = {"jax": jsc, "torch": sc}
EQUAL = ("ticks", "n_pods", "replans", "lut_hits", "boosts", "rebalances",
         "replan_reasons", "condemned", "states", "state_trace", "events",
         "migrated", "quarantines", "pod_restores", "staged_commits",
         "quarantined", "stale_fallbacks", "degraded_ticks", "frozen_ticks",
         "safe_states", "below_axis_clamps", "write_nacks", "write_retries",
         "watchdog_events")
CLOSE = ("mean_saving", "energy_j", "t_max")


def _prof(TFmod):
    return TFmod.StepProfile.from_roofline(compute_s=0.8, memory_s=0.45,
                                           collective_s=0.2)


@pytest.fixture(scope="module")
def rts():
    return {"jax": JRT.EnergyAwareRuntime(_prof(JTF), policy="power_save"),
            "torch": RT.EnergyAwareRuntime(_prof(TF), policy="power_save",
                                           device="cpu")}


def hold(got, want):
    np.testing.assert_array_equal(got.rails, want.rails)
    np.testing.assert_array_equal(got.shares, want.shares)
    for name in EQUAL:
        assert getattr(got, name) == getattr(want, name), name
    for name in CLOSE:
        assert getattr(got, name) == pytest.approx(getattr(want, name),
                                                   rel=REL), name


def _stale_nack_storm(smod, cmod):
    """tests/test_fleet.py::TestWatchdogOutranksStaleness's day."""
    d = smod.diurnal(ticks=12)
    return smod.Scenario(
        name="stale_nack_storm", ticks=12, ambient=d.ambient,
        load=lambda now: 0.9,
        chaos=lambda: cmod.ControlFaultModel(
            rate=0.0, seed=1, stale=0.9, dropout=0.0, spike=0.0, stuck=0.0,
            nack=0.9, sensor_window=(3, 9), nack_window=(3, 9),
            deadline_misses=(3, 4)))


# (day factory, fleet_replay keyword arguments) per case
CASES = {
    "pod_loss_2": (lambda s, c: s.pod_loss_day(ticks=16), dict(n_pods=2)),
    "pod_loss_1": (lambda s, c: s.pod_loss_day(ticks=16), dict(n_pods=1)),
    "last_pod": (lambda s, c: s.pod_loss_day(ticks=16, fail_pod=0),
                 dict(n_pods=1)),
    "chaos_2": (lambda s, c: s.chaos_day(ticks=12), dict(n_pods=2)),
    "clean_1": (lambda s, c: s.diurnal_load_spike(ticks=10),
                dict(n_pods=1)),
    "clean_2": (lambda s, c: s.diurnal_load_spike(ticks=10),
                dict(n_pods=2)),
    "stale_nack_2": (_stale_nack_storm, dict(n_pods=2)),
    "latency_offset_budget_2": (
        lambda s, c: s.pod_loss_day(ticks=16),
        dict(n_pods=2, write_latency_s=1.0, amb_offset_c=2.0,
             power_budget_w=40000.0)),
}


@pytest.fixture(scope="module")
def runs(rts):
    """Every case through both packages' fleet_replay, once."""
    out = {}
    for case, (day, kw) in CASES.items():
        for side in ("torch", "jax"):
            out[side, case] = SMODS[side].fleet_replay(
                day(SMODS[side], MODS[side]), runtime=rts[side], sweep=SW,
                util_sweep=US, **kw)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_fleet_replay_equals_the_reference(runs, case):
    got = runs["torch", case]
    hold(got, runs["jax", case])
    assert got.t_max < TF.T_MAX_CHIP


# ---------------------------------------------------------------------------
# the §10 contracts within the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("day", ["diurnal_load_spike", "chaos_day"])
def test_one_pod_fleet_is_the_flat_loop(rts, runs, day):
    ticks = 10 if day == "diurnal_load_spike" else 12
    scn = sc.SCENARIOS[day](ticks=ticks)
    flat = sc.replay(scn, runtime=rts["torch"], sweep=SW, util_sweep=US)
    one = sc.fleet_replay(scn, n_pods=1, runtime=rts["torch"], sweep=SW,
                          util_sweep=US)
    assert one.fingerprint == flat.fingerprint
    assert one.replans == flat.replans
    assert one.replan_reasons == flat.replan_reasons
    for name in ("write_nacks", "frozen_ticks", "safe_states"):
        assert getattr(one, name) == getattr(flat, name), name
    if day == "diurnal_load_spike":
        assert one.fingerprint == runs["torch", "clean_1"].fingerprint


def test_clean_day_is_pod_count_invariant(rts, runs):
    four = sc.fleet_replay(sc.diurnal_load_spike(ticks=10), n_pods=4,
                           runtime=rts["torch"], sweep=SW, util_sweep=US)
    fps = {n: runs["torch", f"clean_{n}"].fleet_fingerprint for n in (1, 2)}
    assert fps[1] == fps[2] == four.fleet_fingerprint, fps
    assert runs["torch", "clean_2"].replan_reasons.count("cold_start") == 2


def test_pod_loss_walks_the_ladder_and_restores(runs):
    day = runs["torch", "pod_loss_2"]
    assert day.quarantines == 1 and day.pod_restores == 1
    assert [e.split("@")[0] for e in day.events] == [
        "pod1:degraded", "pod1:quarantined", "pod1:drained",
        "pod1:restored"]
    assert all(t[0] == ctl.HEALTHY for t in day.state_trace)
    drained = [i for i, t in enumerate(day.state_trace)
               if t[1] == ctl.DRAINED]
    lo = day.rails.shape[2] // 2
    assert np.allclose(day.rails[drained[0], 0, lo:], TF.V_CORE_NOM)
    assert day.condemned == () and day.states == {0: ctl.HEALTHY,
                                                  1: ctl.HEALTHY}
    assert day.shares.sum() == pytest.approx(day.rails.shape[2])


def test_last_pod_is_never_quarantined(runs):
    a = runs["torch", "last_pod"]
    assert a.quarantines == 0
    assert any("quarantine_deferred" in e for e in a.events)


def test_watchdog_outranks_staleness(runs):
    a = runs["torch", "stale_nack_2"]
    assert a.frozen_ticks >= 1 and a.stale_fallbacks >= 1
    assert a.write_nacks >= 1
    assert all(r == "cold_start" or r.startswith("ambient_jump")
               for r in a.replan_reasons), a.replan_reasons


def test_rate_zero_multi_pod_is_identity(rts, runs):
    wrapped = sc.fleet_replay(sc.diurnal_load_spike(ticks=10), n_pods=2,
                              runtime=rts["torch"], sweep=SW, util_sweep=US,
                              faults=ctl.ControlFaultModel(rate=0.0))
    assert wrapped.fingerprint == runs["torch", "clean_2"].fingerprint
    assert wrapped.write_nacks == 0 and wrapped.quarantined == 0


def test_fleet_replay_is_deterministic(rts, runs):
    again = sc.fleet_replay(sc.pod_loss_day(ticks=16), n_pods=2,
                            runtime=rts["torch"], sweep=SW, util_sweep=US)
    assert again.fingerprint == runs["torch", "pod_loss_2"].fingerprint
    assert again.events == runs["torch", "pod_loss_2"].events


def test_pods_share_one_solve_per_environment(rts):
    """Two pods replanning at the same sensed environment in one tick pay
    ONE fleet solve and receive slices of it."""
    rt = rts["torch"]
    n = rt.substrate.n_domains
    ctx = ctl.TickContext()
    calls = []
    inner = rt.planner
    orig = inner.plan_at

    def counted(*a, **kw):
        calls.append(a)
        return orig(*a, **kw)

    inner.plan_at = counted
    ctx.util = np.full(n, 0.5, np.float32)  # FleetLoop assembles it first
    try:
        p0 = ctl.PodPlanner(inner, 0, n // 2, ctx=ctx)
        p1 = ctl.PodPlanner(inner, n // 2, n, ctx=ctx)
        a, Ta = p0.plan_at(25.0, np.full(n // 2, 0.5, np.float32))
        b, Tb = p1.plan_at(25.0, np.full(n // 2, 0.5, np.float32))
    finally:
        inner.plan_at = orig
    assert len(calls) == 1 and len(ctx.memo) == 1
    ((full, _),) = ctx.memo.values()
    np.testing.assert_array_equal(np.concatenate([a.v_core, b.v_core]),
                                  full.v_core)
    assert a.t_max == b.t_max == full.t_max
    assert p0.substrate.n_domains == n // 2


# ---------------------------------------------------------------------------
# the plumbing: fan-out views and the pod rail channel
# ---------------------------------------------------------------------------


class _Stub:
    def __init__(self, samples):
        self.samples, self.polls = samples, 0

    def poll(self, now):
        self.polls += 1
        return list(self.samples)


def _view_trace(mod):
    t = np.arange(8, dtype=np.float32) + 50.0
    src = _Stub([
        mod.ChipTempSample(t, stamp=2.0),
        mod.UtilSample(np.arange(8, dtype=np.float32)),
        mod.SafeStateSample(frozenset({1, 5})),
        mod.StragglerSample("w0", 1.0, 2.0, 6),
        mod.StragglerSample("w?", 1.0, 2.0, -1),
        mod.SdcSample(detected=3, corrected=2, escaped=1, checked=10),
        mod.AmbientSample(25.0),
    ])
    fan = mod.FanoutTelemetry(src)
    views = [fan.view(0, 4, primary=True), fan.view(4, 8)]
    out = []
    for now in (1.0, 1.0, 2.0):
        for v in views:
            row = []
            for s in v.poll(now):
                d = {k: (np.asarray(x).tolist() if isinstance(x, np.ndarray)
                         else sorted(x) if isinstance(x, frozenset) else x)
                     for k, x in vars(s).items()}
                row.append((type(s).__name__, d))
            out.append(row)
    return out, src.polls


def test_fanout_views_equal_the_reference():
    got, want = _view_trace(ctl), _view_trace(jctl)
    assert got == want
    assert got[1] == 2  # the shared source drained once per tick


def _channel_trace(mod, rt, TFm):
    fleet = mod.FleetActuator.from_runtime(rt, t_amb=25.0)
    n = rt.substrate.n_domains
    fleet.apply(mod.BoostRail(chip=3, v_core=0.75, v_sram=0.75,
                              extra_power_w=1.0))
    fm = mod.ControlFaultModel(nack=0.5, seed=2)
    ch = mod.PodRailChannel(fleet, 0, n // 2, write_latency_s=1.0,
                            write_faults=fm)
    sib = mod.PodRailChannel(fleet, n // 2, n)
    trace = []
    for now, vc in ((0.0, 0.700), (0.5, 0.705), (1.5, 0.710), (2.0, None)):
        ch.begin_tick(now)
        sib.begin_tick(now)
        if vc is not None:
            ch.apply(mod.SetRails(vc, vc + 0.02, source="lut"))
            sib.apply(mod.SetRails(vc + 0.01, vc + 0.03, source="lut"))
        trace.append((fleet.v_core.tolist(), fleet.v_sram.tolist(),
                      sorted(fleet.safe_state), fleet.write_nacks))
    ch.freeze_safe()
    trace.append((fleet.v_core.tolist(), sorted(fleet.safe_state),
                  ch.staged_commits, ch._staged is None, ch.width, ch.full,
                  fleet.write_faults is None))
    with pytest.raises(ValueError):
        mod.PodRailChannel(fleet, 0, n + 1)
    return trace


def test_pod_rail_channel_equals_the_reference(rts):
    got = _channel_trace(ctl, rts["torch"], TF)
    assert got == _channel_trace(jctl, rts["jax"], JTF)
    assert got[-1][2] >= 1  # a latency-staged write committed


def test_fleet_loop_rejects_a_bad_tiling(rts):
    rt = rts["torch"]
    n = rt.substrate.n_domains
    fleet = ctl.FleetActuator.from_runtime(rt, t_amb=25.0)

    class Idle:
        def decide(self, snap):
            return []

    def pod(i, lo, hi):
        return ctl.PodDomain(index=i, lo=lo, hi=hi,
                             bus=ctl.TelemetryBus([]), controller=Idle(),
                             rails=ctl.PodRailChannel(fleet, lo, hi))

    with pytest.raises(ValueError):
        ctl.FleetLoop([pod(0, 0, n // 2)], fleet)
    with pytest.raises(ValueError):
        ctl.FleetLoop([pod(0, 0, n // 2), pod(1, n // 2 + 1, n)], fleet)
