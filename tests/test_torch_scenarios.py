"""The port's control-plane days (``repro_torch.scenarios``: the named days
of ``SCENARIOS``, ``replay`` and its CLI) against the JAX package, on the
CPU.

Every named day at ``ticks=16`` on the reference's test knots (ambient
sweep ``(15, 40, 4)``, util knots ``(0.25, 1, 3)``, ``tests/test_fleet.py``)
goes through both packages' ``replay`` once (module fixtures). Equal means
equal: the applied rails and the util trace, the replan count, reasons and
fast-path hits, boosts, rebalances, the condemned chips and the elastic
shares, and the whole §9 containment ledger (quarantines, stale fallbacks,
degraded and frozen ticks, safe states, clamps, NACKs, retries, watchdog
events, recovery times). ``mean_saving``, ``energy_j`` and ``t_max`` agree
within 1e-3 relative. The §V ``sdc_storm`` day with a ``FaultInjector`` and
an ``ErrorTolerant`` controller holds its rails, back-offs and restores
equal and its SDC counts to ``sdc_agree`` (``tests/test_torch_faults.py``
says why they are not bit for bit). The reference's sha256 fingerprints
hash floats; the port is held to its own (the same replay twice gives the
same fingerprint).
"""
import dataclasses
import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest

from repro import scenarios as jsc
from repro.core import runtime as JRT
from repro.core import tpu_fleet as JTF
from repro.tolerance import faults as jtol
from repro_torch import control as ctl
from repro_torch import scenarios as sc
from repro_torch.core import runtime as RT
from repro_torch.core import tpu_fleet as TF
from repro_torch.tolerance import faults as tol
from test_torch_faults import one_thread, sdc_agree  # noqa: F401

SW = (15.0, 40.0, 4)  # tests/test_fleet.py's coarse knots
US = (0.25, 1.0, 3)
TICKS = 16
REL = 1e-3  # mean_saving, energy_j, t_max (ROADMAP.md queue 1)
BUDGET = 1e-5  # tests/test_tolerance.py's escaped-SDC budget
DAYS = sorted(sc.SCENARIOS)
SMODS = {"jax": jsc, "torch": sc}

EQUAL = ("ticks", "replans", "lut_hits", "boosts", "rebalances",
         "replan_reasons", "condemned", "backoffs", "restores",
         "quarantined", "stale_fallbacks", "degraded_ticks", "frozen_ticks",
         "safe_states", "below_axis_clamps", "write_nacks", "write_retries",
         "watchdog_events", "recover_ticks")
CLOSE = ("mean_saving", "energy_j", "t_max")


def _prof(TFmod):
    return TFmod.StepProfile.from_roofline(compute_s=0.8, memory_s=0.45,
                                           collective_s=0.2)


def _knots():
    return ctl.sweep_points(*SW), ctl.sweep_points(*US)


@pytest.fixture(scope="module")
def both():
    """{"jax": (runtime, field), "torch": (runtime, field)}."""
    jrt = JRT.EnergyAwareRuntime(_prof(JTF), policy="power_save")
    rt = RT.EnergyAwareRuntime(_prof(TF), policy="power_save", device="cpu")
    return {"jax": (jrt, jrt.build_field(*_knots())),
            "torch": (rt, rt.build_field(*_knots()))}


def _replay(side, both, day, **kw):
    rt, field = both[side]
    smod = SMODS[side]
    return smod.replay(smod.SCENARIOS[day](ticks=TICKS), runtime=rt,
                       controller=rt.controller(field=field,
                                                guard_band_c=3.0), **kw)


@pytest.fixture(scope="module")
def days(both):
    """Every named day through both packages' replay, once."""
    return {(side, day): _replay(side, both, day)
            for day in DAYS for side in ("torch", "jax")}


def hold(got, want, sdc=False):
    """The port's replay holds the reference's decisions."""
    np.testing.assert_array_equal(got.rails, want.rails)
    np.testing.assert_array_equal(got.util_trace, want.util_trace)
    np.testing.assert_array_equal(got.shares, want.shares)
    for name in EQUAL:
        assert getattr(got, name) == getattr(want, name), name
    for name in CLOSE:
        assert getattr(got, name) == pytest.approx(getattr(want, name),
                                                   rel=REL), name
    counts = [[getattr(r, f"sdc_{k}") for k in ("injected", "escaped",
                                                 "checked")]
              for r in (got, want)]
    for r in (got, want):
        assert r.sdc_detected == r.sdc_corrected
        assert r.sdc_detected + r.sdc_escaped == r.sdc_injected
    if sdc:
        sdc_agree(*counts)
    else:
        assert counts[0] == counts[1]


# ---------------------------------------------------------------------------
# the library
# ---------------------------------------------------------------------------


def _day_record(day, ticks):
    rec = [day.name, day.ticks, day.chaos_pod, day.description,
           [dataclasses.astuple(s) for s in day.steps],
           [dataclasses.astuple(h) for h in day.hotspots]]
    rec += [(day.ambient_at(t), day.load_at(t),
             None if day.sdc_noise is None else day.sdc_noise(float(t)))
            for t in range(ticks + 2)]
    if day.chaos is not None:
        fm = day.chaos()
        rec += [fm.sensor_window, fm.nack_window, sorted(fm.deadline_misses),
                sorted(fm.solver_faults), fm.p, fm.nack_p, fm.seed,
                [fm.sensor_fault(float(t)) for t in range(ticks)],
                [fm.nack(8, float(t), 0).tolist() for t in range(ticks)]]
    return rec


@pytest.mark.parametrize("ticks", [None, TICKS])
@pytest.mark.parametrize("day", DAYS)
def test_named_days_equal_the_reference(day, ticks):
    kw = {} if ticks is None else {"ticks": ticks}
    got, want = sc.SCENARIOS[day](**kw), jsc.SCENARIOS[day](**kw)
    assert (_day_record(got, got.ticks)
            == _day_record(want, want.ticks))


def test_churn_workload_equals_the_reference():
    got, want = sc.churn_requests(), jsc.churn_requests()
    assert got.name == want.name and got.fingerprint == want.fingerprint
    assert [dataclasses.astuple(a) for a in got.arrivals] == [
        dataclasses.astuple(a) for a in want.arrivals]


# ---------------------------------------------------------------------------
# replay: every named day
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("day", DAYS)
def test_replay_equals_the_reference(days, day):
    got = days["torch", day]
    hold(got, days["jax", day])
    assert got.ticks == TICKS and got.t_max < TF.T_MAX_CHIP


def test_the_days_exercise_what_they_name(days):
    chaos = days["torch", "chaos_day"]  # the 16-tick day: no stale run
    assert chaos.quarantined > 0 and chaos.recover_ticks
    assert chaos.frozen_ticks > 0 and chaos.safe_states > 0
    assert chaos.write_nacks > 0 and chaos.watchdog_events
    storm = days["torch", "straggler_storm"]
    assert storm.boosts + storm.rebalances >= 1
    jump = days["torch", "ambient_jump"]
    assert any(r.startswith("ambient_jump") for r in jump.replan_reasons)


def test_straggler_storm_migrates_work(both):
    """tests/test_scenarios.py::TestRebalanceMigration on both packages."""
    runs = {}
    for side, smod in SMODS.items():
        rt, field = both[side]
        day = smod.straggler_storm(ticks=20, storm_at=10)
        runs[side] = smod.replay(day, runtime=rt, controller=rt.controller(
            field=field, guard_band_c=3.0))
    got = runs["torch"]
    hold(got, runs["jax"])
    hot = 2  # straggler_storm's slow worker and hot chip
    assert got.rebalances >= 1 and hot in got.condemned
    assert got.shares[hot] == 0.0
    assert float(got.shares.sum()) == pytest.approx(len(got.shares),
                                                    rel=1e-5)
    assert got.util_trace[-1, hot] == 0.0 and got.util_trace[0, hot] > 0.0


def test_scalar_lut_baseline_equals_the_reference(both, days):
    """The pod-median scalar LUT controller (the replan-economy baseline
    of tests/test_scenarios.py) on the diurnal + load-spike day."""
    runs = {}
    for side, smod in SMODS.items():
        rt, _ = both[side]
        runs[side] = smod.replay(
            smod.diurnal_load_spike(ticks=TICKS), runtime=rt,
            controller=rt.controller(lut=rt.build_lut(_knots()[0]),
                                     guard_band_c=3.0))
    base = runs["torch"]
    hold(base, runs["jax"])
    fld = days["torch", "diurnal_load_spike"]
    assert any(r == "util_drift" for r in base.replan_reasons)
    assert not any(r.startswith("util") for r in fld.replan_reasons)
    assert fld.replans < base.replans


def test_sdc_storm_with_an_injector_equals_the_reference():
    """The §V closed loop (tests/test_tolerance.py::TestSdcStorm at 16
    ticks, the spike at tick 6): an ErrorTolerant controller with an SDC
    budget, the injector sampling the applied rails every tick."""
    runs = {}
    for side, smod, TFm, tmod in (("torch", sc, TF, tol),
                                  ("jax", jsc, JTF, jtol)):
        kw = {"device": "cpu"} if side == "torch" else {}
        rt = (RT if side == "torch" else JRT).EnergyAwareRuntime(
            _prof(TFm), policy=f"error_tolerant:{BUDGET}", **kw)
        c = rt.controller(field=rt.build_field(*_knots()),
                          guard_band_c=3.0, sdc_budget=BUDGET)
        inj = tmod.FaultInjector(tmod.TimingFaultModel(rt.lib), seed=7)
        runs[side] = smod.replay(smod.sdc_storm(ticks=TICKS, spike_at=6),
                                 runtime=rt, controller=c, injector=inj)
    got = runs["torch"]
    hold(got, runs["jax"], sdc=True)
    assert got.sdc_injected > 0 and got.backoffs >= 1
    assert got.escape_rate <= BUDGET
    assert got.sdc_detected + got.sdc_escaped == got.sdc_injected


# ---------------------------------------------------------------------------
# determinism within the port
# ---------------------------------------------------------------------------


def test_replay_is_deterministic(both, days):
    again = _replay("torch", both, "chaos_day")
    first = days["torch", "chaos_day"]
    assert again.fingerprint == first.fingerprint
    assert again.watchdog_events == first.watchdog_events
    hold(again, first)


def test_rate_zero_chaos_changes_nothing(both):
    rt, field = both["torch"]
    quiet = dataclasses.replace(sc.chaos_day(ticks=TICKS), chaos=None)
    c = rt.controller(field=field, guard_band_c=3.0)
    clean = sc.replay(quiet, runtime=rt, controller=c)
    zeroed = sc.replay(quiet, runtime=rt, controller=c,
                       faults=ctl.ControlFaultModel(rate=0.0))
    assert zeroed.fingerprint == clean.fingerprint
    assert zeroed.energy_j == clean.energy_j
    assert zeroed.quarantined == 0 and zeroed.safe_states == 0
    assert zeroed.frozen_ticks == 0 and not zeroed.watchdog_events


# ---------------------------------------------------------------------------
# the CLI: python -m repro_torch.scenarios <day> --quick
# ---------------------------------------------------------------------------


def _cli(argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert sc._main(argv) == 0
    return json.loads(buf.getvalue())


def test_cli_chaos_day_on_the_cpu(days):
    out = _cli(["chaos_day", "--quick", "--json", "--device", "cpu"])
    want = days["jax", "chaos_day"]
    assert out["fingerprint"] == days["torch", "chaos_day"].fingerprint
    for k in ("replans", "lut_hits", "quarantined", "stale_fallbacks",
              "degraded_ticks", "frozen_ticks", "safe_states", "write_nacks",
              "below_axis_clamps", "watchdog_events"):
        assert out[k] == getattr(want, k), k
    assert out["t_max"] < TF.T_MAX_CHIP and out["wall_s"] > 0


def test_cli_pod_loss_day_on_the_cpu(both):
    out = _cli(["pod_loss_day", "--quick", "--json", "--device", "cpu"])
    jrt, _ = both["jax"]
    want = jsc.fleet_replay(jsc.pod_loss_day(ticks=TICKS), n_pods=2,
                            runtime=jrt, sweep=SW, util_sweep=US)
    assert out["events"] == want.events
    assert out["quarantines"] == 1 and out["pod_restores"] == 1
    assert out["states"] == {"0": "healthy", "1": "healthy"}


def test_cli_defaults_to_the_card():
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sc._main(["diurnal", "--quick"])
