"""The port's §9 chaos plane and fault-tolerance pieces
(``repro_torch.control.faults``, ``repro_torch.ft``,
``repro_torch.launch.mesh.PodTopology``,
``repro_torch.control.MonitorTelemetry``,
``repro_torch.tolerance.SdcTelemetry``) against the JAX package, on the CPU.

The cases of ``tests/test_control_faults.py`` and the ``ft/monitor`` cases
of ``tests/test_control.py``, fed to both packages. Equal means equal: the
fault model's draws (sensor classes and NACK masks, stream for stream, per
pod), the corrupted samples and their stamps, the bus's snapshots and
quarantine counts tick for tick, the controller's actions and counters
under stale, watchdog and safe-state inputs, the rail channel's applied
rails, safe-state set and retry counters, the straggler events and the
rolling median, the worker -> chip mapping and the elastic shares bit for
bit. The SDC counts are held to ``sdc_agree`` (see there why not bit for
bit).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro import control as jctl
from repro.core import runtime as JRT
from repro.core import tpu_fleet as JTF
from repro.ft import elastic as jelastic
from repro.ft import monitor as jmonitor
from repro.launch.mesh import PodTopology as JPodTopology
from repro.tolerance import faults as jtol
from repro_torch import control as ctl
from repro_torch.core import runtime as RT
from repro_torch.core import tpu_fleet as TF
from repro_torch.ft import elastic, monitor
from repro_torch.launch.mesh import PodTopology
from repro_torch.policy.policies import ABFT_ESCAPE
from repro_torch.tolerance import faults as tol

MODS = {"jax": jctl, "torch": ctl}
T_KNOTS = (10.0, 45.0, 4)  # tests/test_control_faults.py's knots


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The control plane's tensors are a 256-chip pod: many small ops. With
    several test processes sharing the cores, each op's thread team waits
    on descheduled threads, so these modules run torch on one thread (no
    op here is large enough for its result to depend on the count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
U_KNOTS = (0.25, 1.0, 4)


def _prof(TFmod):
    return TFmod.StepProfile.from_roofline(compute_s=0.8, memory_s=0.45,
                                           collective_s=0.2)


@pytest.fixture(scope="module")
def both():
    """{"jax": (runtime, field), "torch": (runtime, field)}."""
    jrt = JRT.EnergyAwareRuntime(_prof(JTF), policy="power_save")
    rt = RT.EnergyAwareRuntime(_prof(TF), policy="power_save", device="cpu")
    knots = (ctl.sweep_points(*T_KNOTS), ctl.sweep_points(*U_KNOTS))
    return {"jax": (jrt, jrt.build_field(*knots)),
            "torch": (rt, rt.build_field(*knots))}


# ---------------------------------------------------------------------------
# the fault model: the reference's draws, stream for stream
# ---------------------------------------------------------------------------

MODELS = {
    "rate0": dict(rate=0.0),
    "rate08": dict(rate=0.8, seed=3),
    "windowed": dict(rate=1.0, seed=0, sensor_window=(5, 10),
                     nack_window=(2, 6)),
    "classes": dict(rate=0.6, seed=7, nack=0.5, dropout=0.45, spike=0.1,
                    stale=0.05, stuck=0.0, sensor_window=(2, 9),
                    nack_window=(4, 6), deadline_misses=(3,),
                    solver_faults=(5,)),
}


def _draws(fm, pod=None):
    if pod is not None:
        fm = fm.for_pod(pod)
    sensors = [fm.sensor_fault(float(t)) for t in range(64)]
    nacks = [fm.nack(16, float(t), t % 3).tolist() for t in range(16)]
    script = [(fm.deadline_miss(t + 0.4), fm.solver_fault(float(t)))
              for t in range(12)]
    return sensors, nacks, script, fm.seed


@pytest.mark.parametrize("pod", [None, 0, 1, 3])
@pytest.mark.parametrize("name", list(MODELS))
def test_fault_draws_equal_the_reference(name, pod):
    got = _draws(ctl.ControlFaultModel(**MODELS[name]), pod)
    assert got == _draws(jctl.ControlFaultModel(**MODELS[name]), pod)
    fm = ctl.ControlFaultModel(**MODELS[name])
    first = _draws(fm, pod)
    fm.reset()
    assert _draws(fm, pod) == first  # reset replays identically
    if name == "rate0":
        assert all(s is None for s in got[0])
        assert not any(any(m) for m in got[1])


def test_sibling_pods_decorrelate_and_keep_the_scripts():
    base = ctl.ControlFaultModel(**MODELS["classes"])
    d = [_draws(base, p)[0] for p in (0, 1, 2)]
    assert d[1] != d[0] and d[1] != d[2]
    p = base.for_pod(3)
    assert p.sensor_window == (2, 9) and p.nack_window == (4, 6)
    assert p.deadline_miss(3.0) and p.solver_fault(5.0)
    assert p.nack_p == 0.5 and p.rate == 0.6


# ---------------------------------------------------------------------------
# sensor-side corruption
# ---------------------------------------------------------------------------


def _one_class(mod, cls, **kw):
    p = {c: 0.0 for c in ("dropout", "spike", "stale", "stuck")}
    p[cls] = 1.0
    return mod.ControlFaultModel(seed=0, **p, **kw)


class _ChipSource:
    """Chip-temperature samples that change every tick."""

    def __init__(self, mod):
        self.mod = mod

    def poll(self, now):
        return [self.mod.ChipTempSample(np.arange(4, dtype=np.float32)
                                        + 60.0 + now),
                self.mod.SafeStateSample(frozenset({1}))]


def _trace(samples):
    out = []
    for s in samples:
        d = dataclasses.asdict(s)
        out.append((type(s).__name__,
                    {k: (np.asarray(v).tolist()
                         if isinstance(v, np.ndarray) else v)
                     for k, v in d.items()}))
    return out


CORRUPT = {
    "dropout": lambda m: _one_class(m, "dropout"),
    "spike": lambda m: _one_class(m, "spike"),
    "stale": lambda m: _one_class(m, "stale"),
    "stuck": lambda m: _one_class(m, "stuck", sensor_window=(0, 1),
                                  stuck_ticks=3),
    "mixed": lambda m: m.ControlFaultModel(rate=0.8, seed=5),
    "rate0": lambda m: m.ControlFaultModel(rate=0.0),
}


@pytest.mark.parametrize("source", ["ambient", "chip"])
@pytest.mark.parametrize("case", list(CORRUPT))
def test_chaos_samples_equal_the_reference(case, source):
    out = {}
    for side, mod in MODS.items():
        src = (mod.AmbientSensor(lambda now: 20.0 + now)
               if source == "ambient" else _ChipSource(mod))
        wrap = mod.ChaosTelemetry(src, CORRUPT[case](mod))
        out[side] = [_trace(wrap.poll(float(t))) for t in range(12)]
    assert out["torch"] == out["jax"]
    if case == "rate0" and source == "ambient":
        assert out["torch"] == [[("AmbientSample", {"t_amb": 20.0 + t,
                                                    "stamp": None})]
                                for t in range(12)]
    if case == "stale" and source == "ambient":
        assert out["torch"][1] == [("AmbientSample",
                                    {"t_amb": 20.0, "stamp": 0.0})]


# ---------------------------------------------------------------------------
# the bus: quarantine, last-good carry, per-source freshness
# ---------------------------------------------------------------------------


class _Script:
    def __init__(self, rows):
        self.rows = rows

    def poll(self, now):
        return self.rows[int(now)] if int(now) < len(self.rows) else []


def _bus_rows(mod):
    A, C = mod.AmbientSample, mod.ChipTempSample
    hot = np.full(4, 70.0, np.float32)
    return [
        [A(25.0), C(hot)],
        [A(525.0), C(hot + 900.0)],       # spikes: outside the valid range
        [],                               # dropout
        [A(24.0, stamp=1.0), C(hot, stamp=3.0)],  # stale amb, fresh chip
        [A(24.0), mod.SafeStateSample(frozenset({3, 7}))],
        [A(23.0, stamp=5.0)],
    ]


def _snap_key(s):
    return (s.t_amb, s.t_amb_age, s.quarantined, s.t_chip_age,
            None if s.t_chip is None else np.asarray(s.t_chip).tolist(),
            sorted(s.safe_state))


@pytest.mark.parametrize("max_age", [None, 0.75])
def test_bus_snapshots_equal_the_reference(max_age):
    out = {}
    for side, mod in MODS.items():
        bus = mod.TelemetryBus([_Script(_bus_rows(mod))], max_age=max_age)
        out[side] = ([_snap_key(bus.poll(float(t))) for t in range(8)],
                     bus.quarantined_total)
    assert out["torch"] == out["jax"]
    if max_age is not None:
        assert out["torch"][1] > 0


def test_bus_freshness_is_per_source():
    """tests/test_fleet.py::TestBusPerSourceFreshness on both packages."""
    def run(mod):
        class Amb:
            def __init__(self):
                self.until = None

            def poll(self, now):
                if self.until is not None and now > self.until:
                    return []
                return [mod.AmbientSample(t_amb=25.0 + now)]

        a, b = Amb(), Amb()
        bus = mod.TelemetryBus([a, b], max_age=0.75)
        bus.poll(0.0)
        b.until = 0.0
        s1 = bus.poll(1.0)
        a.until = 1.0
        s3 = bus.poll(3.0)
        return (s1.t_amb, s1.t_amb_age, s3.t_amb, s3.t_amb_age)

    assert run(ctl) == run(jctl) == (26.0, 0.0, 26.0, 2.0)


# ---------------------------------------------------------------------------
# the controller under stale, watchdog and safe-state inputs
# ---------------------------------------------------------------------------


def _actions(acts):
    """Actions as comparable records (a solver plan rides along on a
    replan's SetRails: its rails are the action's own, its float ledger is
    held elsewhere)."""
    out = []
    for a in acts:
        d = {k: (np.asarray(v, np.float32).tolist()
                 if isinstance(v, np.ndarray) else v)
             for k, v in vars(a).items() if k != "plan"}
        out.append((type(a).__name__, d))
    return out


def _stats(c):
    return dataclasses.astuple(c.stats)


HOT = np.full(256, 94.0, np.float32)


def _ctl_script(mod):
    """(controller kwargs, fault model, [(snapshot kwargs, deadline miss)])
    per case."""
    S = dict
    return {
        "stale_fallback": ({"stale_after": 2.0}, None, [
            (S(now=0.0, t_amb=25.0, t_amb_age=5.0), False),
            (S(now=1.0, t_amb=25.0, t_amb_age=5.0, t_chip=HOT), False)]),
        "watchdog_ladder": ({"watchdog_hysteresis": 2}, None, [
            (S(now=0.0, t_amb=25.0), False),
            (S(now=1.0, t_amb=25.0), True),
            (S(now=2.0, t_amb=31.0), True),
            (S(now=3.0, t_amb=25.0), False),
            (S(now=4.0, t_amb=25.0), False),
            (S(now=5.0, t_amb=25.0), False),
            (S(now=6.0, t_amb=25.0), False)]),
        "solver_divergence": ({}, mod.ControlFaultModel(
            solver_faults=(0,), deadline_misses=(2,)), [
            (S(now=0.0, t_amb=25.0), False),
            (S(now=1.0, t_amb=30.0), False),
            (S(now=2.0, t_amb=44.0), False)]),
        "safe_state": ({}, None, [
            (S(now=0.0, t_amb=25.0, safe_state=frozenset({2, 5})), False),
            (S(now=1.0, t_amb=25.0, safe_state=frozenset({2, 5})), False),
            (S(now=2.0, t_amb=25.0, safe_state=frozenset({2, 5, 9})),
             False)]),
    }


@pytest.mark.parametrize("case", ["stale_fallback", "watchdog_ladder",
                                  "solver_divergence", "safe_state"])
def test_controller_decisions_equal_the_reference(both, case):
    out = {}
    for side, mod in MODS.items():
        rt, field = both[side]
        kw, fm, script = _ctl_script(mod)[case]
        c = mod.LutController(rt.planner, field=field, guard_band_c=3.0,
                              faults=fm, **kw)
        c.reset()
        acts = []
        for snap, miss in script:
            if miss:
                c.note_deadline_miss()
            acts.append(_actions(c.decide(mod.Snapshot(**snap))))
            acts[-1].append(("level", c.watchdog_level))
        out[side] = (acts, _stats(c))
    assert out["torch"] == out["jax"]
    if case == "watchdog_ladder":
        sources = [a[0][1]["source"] for a in out["torch"][0]]
        assert sources[1:3] == ["lut", "frozen"]


# ---------------------------------------------------------------------------
# the rail-write channel: verify-after-write, retries, safe state
# ---------------------------------------------------------------------------

WRITES = {
    "total_nack": lambda m: m.ControlFaultModel(nack=1.0),
    "partial_nack": lambda m: m.ControlFaultModel(nack=0.4, seed=1),
    "windowed": lambda m: m.ControlFaultModel(nack=1.0, nack_window=(0, 1)),
    "rate0": lambda m: m.ControlFaultModel(rate=0.0),
}


@pytest.mark.parametrize("case", list(WRITES))
def test_rail_channel_equals_the_reference(both, case):
    out = {}
    for side, mod in MODS.items():
        rt, field = both[side]
        fleet = mod.FleetActuator.from_runtime(rt, t_amb=25.0, field=field)
        fleet.write_faults = WRITES[case](mod)
        vc, vs = field.lookup(25.0)
        act = mod.SetRails(np.asarray(vc, np.float32),
                           np.asarray(vs, np.float32), source="lut")
        trace = []
        for t in (0.0, 5.0):
            fleet.begin_tick(t)
            fleet.apply(act)
            fleet.clear_safe_state(0)
            trace.append((fleet.v_core.tolist(), fleet.v_sram.tolist(),
                          sorted(fleet.safe_state)))
        safe = [s for s in fleet.poll(0.0)
                if isinstance(s, mod.SafeStateSample)]
        out[side] = (trace, fleet.write_nacks, fleet.write_retries,
                     fleet.backoff_wait_us, len(fleet.safe_log),
                     [sorted(s.chips) for s in safe])
    assert out["torch"] == out["jax"]
    if case == "total_nack":
        # every chip pins, then chip 0 again after its clear
        assert out["torch"][2] > 0 and out["torch"][4] == 257


# ---------------------------------------------------------------------------
# ft/monitor: the rolling median, the detector, heartbeats, retries
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window,choices", [(5, None), (3, (1.0, 1.5, 2.0))])
def test_rolling_median_and_events_equal_the_reference(window, choices):
    """tests/test_control.py::TestRollingMedian's fuzz on both packages:
    the median after every step and every straggler event."""
    out = {}
    for side, mod in (("torch", monitor), ("jax", jmonitor)):
        rng = np.random.default_rng(7)
        det = mod.StragglerDetector(threshold=1.3, window=window,
                                    min_samples=4)
        meds, evs = [], []
        for i in range(300):
            w = f"worker{int(rng.integers(0, 6))}"
            v = (float(rng.uniform(0.5, 3.0)) if choices is None
                 else float(rng.choice(choices)))
            ev = det.record(w, i, v)
            meds.append(det._median.median)
            if ev is not None:
                evs.append(dataclasses.astuple(ev))
        out[side] = (meds, evs)
    assert out["torch"] == out["jax"]
    assert out["torch"][1]  # stragglers were flagged


def test_rolling_median_duplicates():
    m = monitor._RollingMedian()
    for v in [1.0, 2.0, 2.0, 3.0]:
        m.add(v)
    m.remove(2.0)
    assert m.median == 2.0 and len(m) == 3
    m = monitor._RollingMedian()
    for v in [1.0, 1.0, 1.0, 2.0, 2.0]:
        m.add(v)
    assert m.median == 1.0
    m.remove(1.0)
    assert m.median == 2.0
    m.remove(2.0)
    assert m.median == 1.0 and len(m) == 3


def test_heartbeat_and_retry_step_equal_the_reference():
    out = {}
    for side, mod in (("torch", monitor), ("jax", jmonitor)):
        hb = mod.Heartbeat(timeout_s=10.0)
        for w, t in (("a", 0.0), ("b", 5.0), ("c", 12.0)):
            hb.beat(w, t)
        inj = mod.FailureInjector(fail_at={1, 3})
        calls, fails = [], []

        def step(k):
            calls.append(k)
            inj.maybe_fail(k)
            return k * 2

        got = [mod.retry_step(step, k, max_retries=2,
                              on_failure=lambda a, e: fails.append(a))
               for k in range(5)]
        with pytest.raises(mod.TransientError):
            mod.retry_step(lambda: inj.maybe_fail(9) or
                           (_ for _ in ()).throw(mod.TransientError("x")),
                           max_retries=1)
        out[side] = (sorted(hb.dead(20.0)), sorted(hb.alive(20.0)), got,
                     calls, fails)
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == ["a", "b"] and out["torch"][4] == [0, 0]


# ---------------------------------------------------------------------------
# the pod topology, the monitor telemetry, the elastic assignment
# ---------------------------------------------------------------------------

WORKERS = ["worker7", "tpu-v4-rank12", "host1-worker3", "coordinator",
           "worker255", "worker256", "worker300", "host0-worker9", "w-12-5"]
TOPOLOGIES = [dict(), dict(grid=(4, 4), n_pods=2, workers_per_host=4),
              dict(grid=(4, 4), n_pods=2, pod_index=1),
              dict(grid=(4, 4), n_pods=2, pod_index=None)]


@pytest.mark.parametrize("kw", TOPOLOGIES, ids=range(len(TOPOLOGIES)))
def test_topology_equals_the_reference(kw):
    def run(cls):
        t = cls(**kw)
        return ([(t.rank_of(w), t.chip_of(w)) for w in WORKERS],
                [(t.pod_of(r), t.coords(r), t.chip_of_rank(r))
                 for r in range(0, t.n_chips + 3, 3)],
                [t.chip_range(p) for p in range(t.n_pods)],
                (t.chips_per_pod, t.n_chips))

    assert run(PodTopology) == run(JPodTopology)


@pytest.mark.parametrize("n,pods", [(16, 2), (16, 4), (8, 1), (256, 2),
                                    (16, 3), (16, 0)])
def test_partition_equals_the_reference(n, pods):
    def run(cls):
        try:
            return cls.partition(n, pods)
        except ValueError:
            return "ValueError"

    assert run(PodTopology) == run(JPodTopology)
    if n % max(pods, 1) or pods == 0:
        assert run(PodTopology) == "ValueError"


def test_monitor_telemetry_equals_the_reference():
    out = {}
    for side, mod, mon_mod, topo in (
            ("torch", ctl, monitor, PodTopology(grid=(4, 4))),
            ("jax", jctl, jmonitor, JPodTopology(grid=(4, 4)))):
        hb = mon_mod.Heartbeat(timeout_s=1e9)
        hb.beat("worker1", 0.0)
        src = mod.MonitorTelemetry(
            mon_mod.StragglerDetector(threshold=1.5, window=8,
                                      min_samples=4),
            heartbeat=hb, topology=topo)
        plain = mod.MonitorTelemetry(mon_mod.StragglerDetector(
            threshold=1.5, window=8, min_samples=4))
        polls = []
        for t in range(6):
            for w in ("worker1", "worker7", "worker31", "gpu"):
                slow = 2.5 if (t >= 3 and w != "worker1") else 1.0
                src.record_step(w, t, slow)
                plain.record_step(w, t, slow)
            polls.append(_trace(src.poll(float(t)))
                         + _trace(plain.poll(float(t))))
        out[side] = polls
    assert out["torch"] == out["jax"]
    chips = [d["chip"] for row in out["torch"] for n, d in row
             if n == "StragglerSample"]
    assert -1 in chips and 7 in chips  # unmapped names, validated ranks


def test_elastic_assignment_equals_the_reference():
    """A seeded condemn/restore sequence (repeats, out-of-range chips, the
    last-chip guard) on both packages: shares bit for bit after every
    step, the pod views and the mesh hint."""
    out = {}
    for side, mod, cmod in (("torch", elastic, ctl),
                            ("jax", jelastic, jctl)):
        rng = np.random.default_rng(3)
        asg = mod.ElasticWorkAssignment(8)
        act = mod.ElasticActuator(asg)
        trace = []
        for _ in range(40):
            chip = int(rng.integers(-1, 10))
            a = (cmod.Rebalance(chip, "test") if rng.random() < 0.6
                 else cmod.Restore(chip))
            handled = act.apply(a)
            (smp,) = act.poll(0.0)
            trace.append((handled, asg.shares.tobytes(), smp.shares.tobytes(),
                          sorted(asg.condemned), asg.pod_share(0, 4),
                          asg.condemned_in(4, 8), asg.mesh_hint(2),
                          asg.util(0.5).tobytes()))
        out[side] = (trace, act.apply(cmod.SetRails(0.7, 0.7, "lut")))
    assert out["torch"] == out["jax"]
    assert any(t[3] for t in out["torch"][0])


def test_elastic_last_chip_and_conservation():
    a = elastic.ElasticWorkAssignment(2)
    a.condemn(0)
    a.condemn(1)  # someone has to do the work
    assert a.shares[1] > 0.0 and a.mesh_hint() == (1, 1)
    b = elastic.ElasticWorkAssignment(8)
    for c in range(4, 8):
        b.condemn(c)
    assert b.pod_share(4, 8) == 0.0
    assert b.pod_share(0, 4) == pytest.approx(1.0)
    for c in range(4, 8):
        b.restore(c)
    assert float(b.shares.sum()) == pytest.approx(8.0, rel=1e-6)


# ---------------------------------------------------------------------------
# the §V SDC counter readout
# ---------------------------------------------------------------------------


class _Fleet:
    """What SdcTelemetry reads of a fleet actuator: the applied rails, the
    settled field (the port reads its host copy ``t_chip``) and the load."""

    def __init__(self, v_core, v_sram, T, util):
        self.v_core, self.v_sram = v_core, v_sram
        self.T = self.t_chip = T
        self.util_applied = util


# The per-MAC SDC rate takes float32 powers of the rails and the field;
# the reference's (XLA's) float32 pow and torch's differ in the last bit
# for ~2% of inputs, and at ~1e6 expected flips per chip and tick one ulp
# of the rate moves a Poisson draw by a few flips (the injected counts of
# the sdc_storm day are 7e-7 apart). The escaped count is then a binomial
# draw over a different n from the same stream: it moves by up to a few
# standard deviations of that draw. So the counts are held to
# ``sdc_agree``, and the decisions they drive (back-offs, restores, rails)
# are held equal in tests/test_torch_scenarios.py.
SDC_RTOL = 1e-5
SDC_SIGMAS = 5.0


def sdc_agree(got, want):
    """(injected, escaped, checked) of two samplings of the same state
    agree: the MACs checked equal, injected within SDC_RTOL, escaped
    within SDC_SIGMAS standard deviations of the binomial split (ABFT
    escape probability p) plus p times the injected gap."""
    (gi, ge, gc), (wi, we, wc) = got, want
    p = ABFT_ESCAPE
    assert gc == wc
    assert abs(gi - wi) <= SDC_RTOL * max(wi, 1)
    assert abs(ge - we) <= (SDC_SIGMAS * np.sqrt(wi * p * (1 - p))
                            + p * abs(gi - wi) + 1)


def _sdc_ticks(n_ticks=10, chips=256):
    rng = np.random.default_rng(0)
    ticks = []
    for _ in range(n_ticks):
        # rails around the guard band, as an ErrorTolerant day applies
        vc = rng.uniform(0.69, 0.76, chips).astype(np.float32)
        vs = np.full(chips, TF.V_SRAM_NOM, np.float32)
        T = rng.uniform(40.0, 80.0, chips).astype(np.float32)
        u = rng.uniform(0.2, 1.0, chips).astype(np.float32)
        ticks.append(_Fleet(vc, vs, T, u))
    return ticks


def _noise(now):
    return 4.0 if 3 <= now < 6 else 1.0


def _sdc_run(mod, lib, ticks):
    inj = mod.FaultInjector(mod.TimingFaultModel(lib), seed=7, noise=_noise)
    rows = [dataclasses.astuple(mod.SdcTelemetry(inj, fl).poll(float(t))[0])
            for t, fl in enumerate(ticks)]
    return np.asarray(rows, np.float64), dataclasses.astuple(inj.totals)


def test_sdc_telemetry_reads_the_applied_state():
    """The port's readout is its injector's tick at the fleet's applied
    rails, the host copy of the settled field and the settled load."""
    ticks = _sdc_ticks()
    rows, _ = _sdc_run(tol, TF.TpuLibrary(), ticks)
    inj = tol.FaultInjector(tol.TimingFaultModel(TF.TpuLibrary()), seed=7,
                            noise=_noise)
    want = [dataclasses.astuple(inj.tick(float(t), f.v_core, f.v_sram,
                                         f.t_chip, util=f.util_applied))
            for t, f in enumerate(ticks)]
    # SdcSample is (detected, corrected, escaped, checked)
    np.testing.assert_array_equal(rows, np.asarray(want)[:, 1:])
    assert rows[:, 0].sum() > 0  # the undervolted chips injected


@pytest.mark.parametrize("chips", [16, 256])
def test_sdc_counts_agree_with_the_reference(chips):
    ticks = _sdc_ticks(chips=chips)
    got, got_tot = _sdc_run(tol, TF.TpuLibrary(), ticks)
    want, want_tot = _sdc_run(jtol, JTF.TpuLibrary(), ticks)
    # a sample is (detected, corrected, escaped, checked): every flip the
    # checksums catch is corrected, the rest escapes
    for rows in (got, want):
        np.testing.assert_array_equal(rows[:, 0], rows[:, 1])
    for g, w in zip(got, want):
        sdc_agree((g[0] + g[2], g[2], g[3]), (w[0] + w[2], w[2], w[3]))
    sdc_agree(np.asarray(got_tot)[[0, 3, 4]], np.asarray(want_tot)[[0, 3, 4]])
