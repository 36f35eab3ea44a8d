"""Replayable control-plane scenarios (the port of ``repro/scenarios.py``).

- a :class:`Scenario` is pure data: an ambient trace, an optional load
  trace (the serve-engine slot-occupancy fraction), scripted worker step
  times (straggler material), hotspot injections (a failed fan / blocked
  airflow on one chip), an SDC-noise trace and a §9 chaos factory;
  :data:`SCENARIOS` names the library of days;
- :func:`replay` runs a scenario through the full telemetry -> controller
  -> actuator loop (ambient sensor, load telemetry, straggler monitor with
  the pod topology mapping, fleet actuator, elastic work migration, the
  optional SDC injector and chaos plane) and returns a
  :class:`ReplayResult` with the decisions and the energy ledger;
- :func:`fleet_replay` runs it through the §10 multi-pod ``FleetLoop``
  (per-pod controllers over one shared solve, the pod health machine);
- a :class:`RequestWorkload` is a deterministic arrival trace
  (:func:`trace_requests`, :func:`poisson_requests`, :func:`poisson_burst`,
  :func:`churn_requests`);
- :func:`serve_replay` runs a workload through a real serve ``Engine``
  under the control loop, and :func:`fleet_serve_replay` through one engine
  per pod over one shared host page pool (the pod-loss serving drill:
  drain and live migration).

The planner's fixed points and the fleet actuator's thermal settle run on
the runtime's device (``device=None`` is the CUDA card); the model runs on
its own device; the controllers, the fault model, the monitor and the
health machine are host numpy, as in the reference. Same trace -> same
decisions: the scheduler does not read the tokens (``eos_id=-1`` runs
every request to ``max_new``), so cap traces and counts do not depend on
the model's width.

    python -m repro_torch.scenarios chaos_day --quick [--device cpu]
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field as dfield
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch import control as ctl
from repro_torch.core import runtime as RT
from repro_torch.core import tpu_fleet as TF
from repro_torch.ft.elastic import ElasticActuator, ElasticWorkAssignment
from repro_torch.ft.monitor import StragglerDetector
from repro_torch.launch.mesh import PodTopology
from repro_torch.tolerance.faults import SdcTelemetry

# ---------------------------------------------------------------------------
# scenario data model
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class StepRecord:
    """One scripted worker step time, delivered at ``tick``."""
    tick: int
    worker: str
    step_s: float


@dataclass(frozen=True)
class Hotspot:
    """A localized cooling fault: chip ``chip`` reads ``t_chip`` degC at
    ``tick`` (failed fan, blocked airflow) — the straggler/rebalance
    trigger material."""
    tick: int
    chip: int
    t_chip: float


@dataclass(frozen=True)
class Scenario:
    """A day, pure data: traces of ``now -> value``, scripted records and
    a chaos factory (replayable anywhere, any number of times)."""
    name: str
    ticks: int
    ambient: Callable[[float], float]
    load: Optional[Callable[[float], float]] = None
    steps: Tuple[StepRecord, ...] = ()
    hotspots: Tuple[Hotspot, ...] = ()
    # multiplicative SDC-rate disturbance trace (aging / supply-noise
    # spikes) fed to the replay's FaultInjector; None = quiet day (x1)
    sdc_noise: Optional[Callable[[float], float]] = None
    # §9 chaos: a factory returning a fresh seeded ControlFaultModel per
    # replay (a factory keeps Scenario pure data and every replay aligned
    # on the same fault streams); None = clean control plane
    chaos: Optional[Callable[[], "ctl.ControlFaultModel"]] = None
    # §10 fleet tier: confine the chaos to ONE pod's failure domain
    # (fleet_replay); None = fleet-wide chaos (every pod draws its own
    # pod-seeded stream via ControlFaultModel.for_pod)
    chaos_pod: Optional[int] = None
    description: str = ""

    def ambient_at(self, tick: int) -> float:
        return float(self.ambient(float(tick)))

    def load_at(self, tick: int) -> Optional[float]:
        return None if self.load is None else float(self.load(float(tick)))


# ---------------------------------------------------------------------------
# the library
# ---------------------------------------------------------------------------


def diurnal(ticks: int = 48, base: float = 25.0, amp: float = 7.0,
            period: Optional[int] = None) -> Scenario:
    """The quasi-static day: a sine between ``base - amp`` and
    ``base + amp`` — everything should ride the fast path after the cold
    start."""
    p = float(period if period is not None else ticks)
    return Scenario(
        name="diurnal", ticks=ticks,
        ambient=lambda now: base + amp * np.sin(2.0 * np.pi * now / p),
        description="quasi-static diurnal ambient sine")


def ambient_jump(ticks: int = 16, t0: float = 22.0, t1: float = 34.0,
                 at: int = 8) -> Scenario:
    """A cooling failure / hot-aisle event: step change ``t0 -> t1``."""
    return Scenario(
        name="ambient_jump", ticks=ticks,
        ambient=lambda now: t1 if now >= at else t0,
        description=f"step {t0}C -> {t1}C at tick {at}")


def straggler_storm(ticks: int = 24, workers: int = 4, storm_at: int = 12,
                    slow_worker: int = 2, slow_factor: float = 2.2,
                    hot_chip_c: float = 94.5) -> Scenario:
    """A worker turns slow on a chip whose cooling just failed: healthy
    baseline steps establish the rolling median, then ``slow_worker``
    reports ``slow_factor`` x median steps while its chip reads
    ``hot_chip_c`` — boost cannot hold the clock there, so the controller
    must escalate to ``Rebalance`` and the elastic assignment must migrate
    the work off the chip."""
    steps: List[StepRecord] = []
    for t in range(ticks):
        for w in range(workers):
            s = 1.0
            if t >= storm_at and w == slow_worker:
                s = slow_factor
            steps.append(StepRecord(t, f"worker{w}", s))
    hotspots = tuple(Hotspot(t, slow_worker, hot_chip_c)
                     for t in range(storm_at, min(storm_at + 2, ticks)))
    return Scenario(
        name="straggler_storm", ticks=ticks,
        ambient=lambda now: 25.0,
        steps=tuple(steps), hotspots=hotspots,
        description="hot-chip straggler escalating to rebalance")


def load_spike(ticks: int = 48, base: float = 0.95, low: float = 0.45,
               dips: Tuple[Tuple[int, int], ...] = ((12, 8), (32, 8))
               ) -> Scenario:
    """Serving load swinging between ``base`` and ``low`` (off-peak dips /
    recovery spikes).  Every swing crosses the scalar controller's
    ``util_band`` and forces a ``util_drift`` replan; the RailField answers
    it from the utilization axis."""
    def trace(now: float) -> float:
        for start, width in dips:
            if start <= now < start + width:
                return low
        return base

    return Scenario(
        name="load_spike", ticks=ticks,
        ambient=lambda now: 25.0, load=trace,
        description="load swings riding the utilization axis")


def diurnal_load_spike(ticks: int = 48, base: float = 25.0,
                       amp: float = 7.0) -> Scenario:
    """The acceptance day: diurnal ambient AND load spikes at once — the
    scenario the scalar LUT replans through and the RailField serves from
    the table."""
    d = diurnal(ticks, base, amp)
    ls = load_spike(ticks)
    return Scenario(
        name="diurnal_load_spike", ticks=ticks,
        ambient=d.ambient, load=ls.load,
        description="diurnal ambient + serving load spikes")


def sdc_storm(ticks: int = 48, t_amb: float = 28.0, spike_at: int = 20,
              spike_len: int = 6, spike_gain: float = 4.0) -> Scenario:
    """The §V acceptance day: steady warm ambient with an SDC-noise spike
    (aging / supply droop multiplying the raw flip rate by ``spike_gain``)
    in the middle.  An ``ErrorTolerant`` closed loop rides below the guard
    band all day — beating PowerSave on mean power — and the spike forces
    the controller's ``RailBackoff`` retreat; the cumulative escaped-SDC
    rate must still land inside the declared budget."""
    def noise(now: float) -> float:
        return spike_gain if spike_at <= now < spike_at + spike_len else 1.0

    return Scenario(
        name="sdc_storm", ticks=ticks,
        ambient=lambda now: t_amb, sdc_noise=noise,
        description=f"x{spike_gain} SDC-noise spike at tick {spike_at}")


def serve_day(ticks: int = 14, hot: float = 42.0, cool: float = 12.0,
              cool_at: int = 7) -> Scenario:
    """The serving acceptance day (§8): a hot window (peak ambient, rails
    near nominal) followed by a machine-room cool-down.  Tokens served
    during the hot window cost more joules than the same tokens after the
    cool-down — the intertemporal arbitrage the thermal-aware admission
    controller prices."""
    return Scenario(
        name="serve_day", ticks=ticks,
        ambient=lambda now: hot if now < cool_at else cool,
        description=f"hot window {hot}C, cool-down to {cool}C at {cool_at}")


def chaos_day(ticks: int = 48, base: float = 25.0, amp: float = 7.0,
              rate: float = 0.6, nack_rate: float = 0.45, seed: int = 0,
              runaway_chip: int = 3, runaway_c: float = 93.5) -> Scenario:
    """The §9 acceptance day: a diurnal trace carrying, in order, a sensor
    storm (dropout/spike/stale/stuck bursts + one missed tick deadline), a
    rail-write NACK burst (driving chips into safe-state rails), and a
    thermal runaway on one chip (hotspot + a scripted solver fault, so the
    watchdog — not the solver — must contain it).  A load dip below the
    RailField's utilization axis rides along for the clamp counter.
    Fingerprint-pinned: same seed -> the identical day."""
    storm = (ticks // 6, ticks // 6 + max(ticks // 4, 3))
    nack_w = (ticks // 2, ticks // 2 + max(ticks // 8, 2))
    runaway_at = 3 * ticks // 4
    d = diurnal(ticks, base, amp)

    def load(now: float) -> float:
        return 0.15 if storm[0] <= now < storm[0] + 2 else 0.9

    return Scenario(
        name="chaos_day", ticks=ticks,
        ambient=d.ambient, load=load,
        hotspots=tuple(Hotspot(t, runaway_chip, runaway_c)
                       for t in range(runaway_at,
                                      min(runaway_at + 3, ticks))),
        chaos=lambda: ctl.ControlFaultModel(
            rate=rate, seed=seed, nack=nack_rate,
            # weight the mix toward dropout so the ambient stream loses
            # enough consecutive ticks to trip the stale fallback (stuck
            # replays keep resetting the age at the uniform rate/4 mix)
            dropout=rate * 0.75,
            sensor_window=storm, nack_window=nack_w,
            # two consecutive missed deadlines: the ladder must reach
            # level 2 (frozen last-applied rails) and climb back down
            deadline_misses=(storm[0] + 1, storm[0] + 2),
            solver_faults=(runaway_at,)),
        description="sensor storm + rail NACK burst + thermal runaway")


def pod_loss_day(ticks: int = 48, base: float = 25.0, amp: float = 7.0,
                 rate: float = 0.8, nack_rate: float = 0.6, seed: int = 0,
                 fail_pod: int = 1) -> Scenario:
    """The §10 acceptance day: a diurnal fleet where ONE pod's control
    plane goes bad mid-morning — a sensor storm, a rail-write NACK burst
    and three consecutive missed tick deadlines, all confined to
    ``fail_pod`` — while its siblings keep serving.  The fleet health
    machine must walk the pod through degraded -> quarantined -> drained
    (rails frozen at safe state, its work share and in-flight requests
    migrated to the survivors) and, once the storm passes and the slice
    cools below the hysteresis threshold, restore it — all inside the day.

    The three scripted deadline misses pin the pod's watchdog at level
    >= 1 across the storm head, so the walk to quarantine is
    deterministic whatever the sensor-fault draws do.  Replayed by
    :func:`fleet_replay` with ``n_pods >= 2``; fingerprint-pinned."""
    storm = (ticks // 6, ticks // 6 + max(ticks // 4, 4))
    d = diurnal(ticks, base, amp)
    return Scenario(
        name="pod_loss_day", ticks=ticks,
        ambient=d.ambient,
        # moderate constant load: survivors absorb the lost pod's share
        # (~2x their own) without leaving the RailField utilization axis
        load=lambda now: 0.45,
        chaos=lambda: ctl.ControlFaultModel(
            rate=rate, seed=seed, nack=nack_rate,
            # quarantinable classes dominate: the health machine keys on
            # bus rejections and watchdog trips, not silent dropouts
            dropout=rate * 0.25,
            sensor_window=storm, nack_window=(storm[0], storm[0] + 2),
            deadline_misses=(storm[0], storm[0] + 1, storm[0] + 2)),
        chaos_pod=fail_pod,
        description="one pod lost to control-plane chaos, then restored")


SCENARIOS: Dict[str, Callable[[], Scenario]] = {
    "diurnal": diurnal,
    "ambient_jump": ambient_jump,
    "straggler_storm": straggler_storm,
    "load_spike": load_spike,
    "diurnal_load_spike": diurnal_load_spike,
    "sdc_storm": sdc_storm,
    "serve_day": serve_day,
    "chaos_day": chaos_day,
    "pod_loss_day": pod_loss_day,
}


# ---------------------------------------------------------------------------
# request workloads (the serving-tier arrival processes)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RequestArrival:
    """One request arriving at control tick ``tick`` (prompt content is
    derived deterministically from ``rid`` at replay time)."""
    tick: int
    rid: int
    prompt_len: int
    max_new: int


@dataclass(frozen=True)
class RequestWorkload:
    """A deterministic arrival trace — pure data, replayable anywhere."""
    name: str
    arrivals: Tuple[RequestArrival, ...]

    @property
    def fingerprint(self) -> str:
        """sha256 of the arrival records (integers only), the reference's
        workload pin."""
        h = hashlib.sha256()
        for a in self.arrivals:
            h.update(np.asarray([a.tick, a.rid, a.prompt_len, a.max_new],
                                np.int64).tobytes())
        return h.hexdigest()[:16]

    def by_tick(self) -> Dict[int, List[RequestArrival]]:
        out: Dict[int, List[RequestArrival]] = {}
        for a in self.arrivals:
            out.setdefault(a.tick, []).append(a)
        return out


def trace_requests(trace, name: str = "trace") -> RequestWorkload:
    """Explicit ``(tick, prompt_len, max_new)`` rows -> a workload (rids
    are assigned in trace order)."""
    arrivals = tuple(RequestArrival(int(t), rid, int(p), int(m))
                     for rid, (t, p, m) in enumerate(trace))
    return RequestWorkload(name, arrivals)


def poisson_requests(ticks: int = 12, rate: float = 1.0, seed: int = 0,
                     prompt_len: Tuple[int, int] = (4, 12),
                     max_new: Tuple[int, int] = (4, 8),
                     start: int = 1) -> RequestWorkload:
    """Poisson arrivals: ``rate`` requests per control tick in expectation,
    prompt/output lengths uniform over the given ranges. The draws are the
    reference's (one ``numpy`` Generator from ``seed``), so the same seed
    gives the reference's workload."""
    rng = np.random.default_rng(seed)
    arrivals: List[RequestArrival] = []
    rid = 0
    for t in range(start, ticks):
        for _ in range(int(rng.poisson(rate))):
            arrivals.append(RequestArrival(
                t, rid, int(rng.integers(*prompt_len)),
                int(rng.integers(*max_new))))
            rid += 1
    return RequestWorkload(f"poisson[rate={rate},seed={seed}]",
                           tuple(arrivals))


def poisson_burst(burst_at: int = 1, burst_n: int = 8,
                  prompt_len: int = 6, max_new: int = 6,
                  tail_ticks: int = 0, tail_rate: float = 0.5,
                  seed: int = 0) -> RequestWorkload:
    """The §8 acceptance workload: a burst of ``burst_n`` requests landing
    at ``burst_at`` (inside the hot window of :func:`serve_day`), optionally
    followed by a light Poisson tail. The burst exceeds the slot count, so
    an admission controller must *choose* what to run hot."""
    arrivals = [RequestArrival(burst_at, rid, prompt_len, max_new)
                for rid in range(burst_n)]
    if tail_ticks > 0:
        tail = poisson_requests(burst_at + 1 + tail_ticks, rate=tail_rate,
                                seed=seed, start=burst_at + 1,
                                prompt_len=(prompt_len, prompt_len + 1),
                                max_new=(max_new, max_new + 1))
        arrivals += [RequestArrival(a.tick, burst_n + a.rid, a.prompt_len,
                                    a.max_new) for a in tail.arrivals]
    return RequestWorkload(f"burst[{burst_n}@{burst_at},seed={seed}]",
                           tuple(arrivals))


def churn_requests(waves: int = 4, per_wave: int = 4, gap: int = 2,
                   prompt_len: int = 5, max_new: int = 5) -> RequestWorkload:
    """The paged-attention acceptance workload: short-lived requests landing
    in overlapping waves, so slots free and refill continuously and the KV
    footprint is many *partial* sequences at once.  A contiguous cache must
    reserve ``max_len`` per slot up front, so its admission capacity is
    ``pages / pages_per_slot``; the paged allocator hands the same page
    budget out one page at a time and admits strictly more concurrently
    (the vLLM fragmentation argument)."""
    arrivals = [RequestArrival(1 + w * gap, w * per_wave + i,
                               prompt_len, max_new)
                for w in range(waves) for i in range(per_wave)]
    return RequestWorkload(f"churn[{waves}x{per_wave},gap={gap}]",
                           tuple(arrivals))


# ---------------------------------------------------------------------------
# replay harness
# ---------------------------------------------------------------------------


def _runtime(runtime, device) -> RT.EnergyAwareRuntime:
    """``runtime``, or the replays' default one (the reference's profile,
    PowerSave) on ``device`` (``None`` is the CUDA card)."""
    if runtime is not None:
        return runtime
    return RT.EnergyAwareRuntime(
        TF.StepProfile.from_roofline(compute_s=0.8, memory_s=0.45,
                                     collective_s=0.2),
        policy="power_save", device=device)


def _by_tick(records) -> Dict[int, list]:
    """Scripted records (step times, hotspots, arrivals) grouped by tick."""
    out: Dict[int, list] = {}
    for r in records:
        out.setdefault(r.tick, []).append(r)
    return out


class _LoadTelemetry:
    """Scripted serve-engine load as TickSamples (slots=64 quantization)."""

    SLOTS = 64

    def __init__(self, scenario: Scenario):
        self.scenario = scenario

    def poll(self, now: float) -> List:
        load = self.scenario.load_at(int(now))
        if load is None:
            return []
        return [ctl.TickSample(
            tick=int(now), queued=0,
            active=int(round(load * self.SLOTS)), finished=0, tokens=0,
            tick_s=0.0, slots=self.SLOTS)]


@dataclass
class ReplayResult:
    name: str
    ticks: int
    replans: int
    lut_hits: int
    boosts: int
    rebalances: int
    replan_reasons: List[str]
    mean_saving: float
    energy_j: float
    t_max: float
    condemned: Tuple[int, ...]
    shares: np.ndarray       # final elastic work shares (chips,)
    rails: np.ndarray        # (ticks, 2, chips) applied (v_core, v_sram)
    util_trace: np.ndarray   # (ticks, chips) utilization the loop settled at
    # §V error-tolerance ledger (all zero on replays without an injector)
    backoffs: int = 0
    restores: int = 0
    sdc_injected: int = 0
    sdc_detected: int = 0
    sdc_corrected: int = 0
    sdc_escaped: int = 0
    sdc_checked: int = 0
    # §9 fault-containment ledger (all zero/empty on clean replays; NOT
    # hashed into the fingerprint so pre-chaos pins are unchanged)
    quarantined: int = 0
    stale_fallbacks: int = 0
    degraded_ticks: int = 0
    frozen_ticks: int = 0
    safe_states: int = 0
    below_axis_clamps: int = 0
    write_nacks: int = 0
    write_retries: int = 0
    watchdog_events: List[str] = dfield(default_factory=list)
    recover_ticks: List[float] = dfield(default_factory=list)

    @property
    def escape_rate(self) -> float:
        """Cumulative escaped-SDC rate per checked MAC over the day."""
        return self.sdc_escaped / self.sdc_checked if self.sdc_checked else 0.0

    @property
    def mean_ticks_to_recover(self) -> float:
        """Mean watchdog-episode length: trip -> back to normal (0 when the
        day had no completed degrade episode)."""
        return float(np.mean(self.recover_ticks)) if self.recover_ticks \
            else 0.0

    @property
    def fingerprint(self) -> str:
        """Determinism pin: hashes the applied rail trace, the replan
        ledger and the energy integral."""
        h = hashlib.sha256()
        h.update(self.rails.astype(np.float64).tobytes())
        h.update(np.float64(self.energy_j).tobytes())
        h.update(",".join(self.replan_reasons).encode())
        h.update(np.asarray(sorted(self.condemned), np.int64).tobytes())
        return h.hexdigest()[:16]


def replay(scenario: Scenario, runtime: Optional[RT.EnergyAwareRuntime]
           = None, controller: Optional[ctl.LutController] = None,
           tick_s: float = 60.0, guard_band_c: float = 3.0,
           sweep=(10.0, 45.0, 8), util_sweep=(0.25, 1.0, 4),
           injector=None, faults=None, device=None) -> ReplayResult:
    """Run ``scenario`` through the full control loop; deterministic.

    ``controller=None`` builds the default RailField controller over the
    runtime's planner; pass a prebuilt controller to compare fast paths
    (e.g. ``rt.controller(lut=rt.build_lut(...))`` for the scalar
    baseline).  ``tick_s`` converts the power readouts into the energy
    ledger (60 s control ticks by default).

    ``injector`` (a ``repro_torch.tolerance.FaultInjector``) attaches the
    §V SDC
    loop: the injector is reset (same seed -> same replayed day), takes the
    scenario's ``sdc_noise`` trace, and samples the fleet's applied rails
    each tick through ``SdcTelemetry`` — pair it with a controller built
    with ``sdc_budget=...`` to close the back-off loop.

    ``faults`` (a ``ControlFaultModel``; defaults to the scenario's own
    ``chaos`` factory) attaches the §9 chaos plane: the ambient sensor and
    the fleet TSDs are wrapped in ``ChaosTelemetry``, the fleet's rail
    writes go through the verify-after-write NACK channel, and the
    controller consumes the scripted watchdog ticks.  ``rate=0`` is the
    identity model — every clean-day fingerprint is unchanged.

    Without ``runtime`` one is built on ``device`` (``None`` is the CUDA
    card): the planner's fixed points and the fleet's settle run there.
    """
    rt = _runtime(runtime, device)
    if controller is None:
        controller = rt.controller(
            field=rt.build_field(ctl.sweep_points(*sweep),
                                 ctl.sweep_points(*util_sweep)),
            guard_band_c=guard_band_c)
    chips = rt.substrate.n_domains
    topo = PodTopology(grid=rt.substrate.grid)

    det = StragglerDetector(threshold=1.5, window=8, min_samples=4)
    mon = ctl.MonitorTelemetry(det, topology=topo)
    assignment = ElasticWorkAssignment(chips)
    elastic = ElasticActuator(assignment)
    fleet = ctl.FleetActuator.from_runtime(
        rt, t_amb=scenario.ambient_at(0),
        field=getattr(controller, "field", None))
    if faults is None and scenario.chaos is not None:
        faults = scenario.chaos()
    amb_src, fleet_src = ctl.AmbientSensor(scenario.ambient), fleet
    if faults is not None:
        amb_src = ctl.ChaosTelemetry(amb_src, faults)
        fleet_src = ctl.ChaosTelemetry(fleet, faults)
        fleet.write_faults = faults
        controller.faults = faults  # scripted deadline/solver-fault ticks
    sources = [amb_src, _LoadTelemetry(scenario), mon, elastic, fleet_src]
    if injector is not None:
        injector.reset()
        if scenario.sdc_noise is not None:
            injector.noise = scenario.sdc_noise
        sources.append(SdcTelemetry(injector, fleet))
    # ticks are 1 apart: a stale-repeated stamp is >= 1 tick old, so the
    # freshness bound must sit under one tick to quarantine it (stamps are
    # only ever set by ChaosTelemetry — clean replays see no age at all)
    bus = ctl.TelemetryBus(sources,
                           max_age=0.75 if faults is not None else None)
    loop = ctl.ControlLoop(bus, controller, [fleet, elastic])

    # a reused controller (warm jits, shared field) must start the day
    # from scratch: reset the online state (t_prev / warm fields / plan),
    # and report stats as deltas (reset leaves the cumulative counters)
    if hasattr(controller, "reset"):
        controller.reset()
    st = controller.stats
    base = (st.replans, st.lut_hits, st.boosts, st.rebalances,
            len(st.replan_reasons), st.backoffs, st.restores,
            st.quarantined, st.stale_fallbacks, st.degraded_ticks,
            st.frozen_ticks, st.safe_states, st.below_axis_clamps,
            len(st.watchdog_events), len(st.recover_ticks))

    steps_by_tick = _by_tick(scenario.steps)
    hot_by_tick = _by_tick(scenario.hotspots)

    rails = np.zeros((scenario.ticks, 2, chips), np.float32)
    util_trace = np.zeros((scenario.ticks, chips), np.float32)
    savings, powers, t_maxes = [], [], []
    for tick in range(scenario.ticks):
        for rec in steps_by_tick.get(tick, ()):
            mon.record_step(rec.worker, tick, rec.step_s)
        for h in hot_by_tick.get(tick, ()):
            fleet.set_temps(h.chip, h.t_chip)  # the TSD reads the fault
        rep = loop.step(now=float(tick))
        rails[tick, 0] = fleet.v_core
        rails[tick, 1] = fleet.v_sram
        u = rep.snapshot.util(chips)
        util_trace[tick] = 1.0 if u is None else u
        ro = rep.readout
        savings.append(ro.saving)
        powers.append(ro.pod_power_w)
        t_maxes.append(ro.t_max)

    tot = injector.totals if injector is not None else None
    return ReplayResult(
        name=scenario.name, ticks=scenario.ticks,
        replans=st.replans - base[0], lut_hits=st.lut_hits - base[1],
        boosts=st.boosts - base[2], rebalances=st.rebalances - base[3],
        replan_reasons=list(st.replan_reasons[base[4]:]),
        mean_saving=float(np.mean(savings)),
        energy_j=float(np.sum(powers) * tick_s),
        t_max=float(np.max(t_maxes)),
        condemned=tuple(sorted(assignment.condemned)),
        shares=assignment.shares.copy(),
        rails=rails, util_trace=util_trace,
        backoffs=st.backoffs - base[5], restores=st.restores - base[6],
        sdc_injected=tot.injected if tot else 0,
        sdc_detected=tot.detected if tot else 0,
        sdc_corrected=tot.corrected if tot else 0,
        sdc_escaped=tot.escaped if tot else 0,
        sdc_checked=tot.checked if tot else 0,
        quarantined=st.quarantined - base[7],
        stale_fallbacks=st.stale_fallbacks - base[8],
        degraded_ticks=st.degraded_ticks - base[9],
        frozen_ticks=st.frozen_ticks - base[10],
        safe_states=st.safe_states - base[11],
        below_axis_clamps=st.below_axis_clamps - base[12],
        write_nacks=fleet.write_nacks, write_retries=fleet.write_retries,
        watchdog_events=list(st.watchdog_events[base[13]:]),
        recover_ticks=list(st.recover_ticks[base[14]:]))


# ---------------------------------------------------------------------------
# fleet replay harness (§10: multi-pod failure domains)
# ---------------------------------------------------------------------------


@dataclass
class FleetReplayResult:
    """One fleet day: per-pod control under the global health authority.

    ``fingerprint`` hashes exactly what :attr:`ReplayResult.fingerprint`
    hashes, so the single-pod degenerate fleet pins bitwise against the
    flat loop.  ``fleet_fingerprint`` drops the replan-reason ledger —
    every pod legitimately logs its own ``cold_start`` — and is the
    pod-count-invariance pin (rails + energy + condemned)."""

    name: str
    ticks: int
    n_pods: int
    replans: int
    lut_hits: int
    boosts: int
    rebalances: int
    replan_reasons: List[str]  # pod-major: pod 0's whole day, then pod 1's
    mean_saving: float
    energy_j: float
    t_max: float
    condemned: Tuple[int, ...]
    shares: np.ndarray       # final elastic work shares (chips,)
    rails: np.ndarray        # (ticks, 2, chips) applied (v_core, v_sram)
    states: Dict[int, str]   # final pod health states
    state_trace: List[Dict[int, str]]  # per-tick pod health states
    events: List[str]        # fleet health events, in order
    migrated: int = 0        # live-migrated in-flight requests
    quarantines: int = 0     # pods walked to quarantine
    pod_restores: int = 0    # pods restored through the cool-down
    staged_commits: int = 0  # latency-buffered rail writes committed
    # §9 containment ledger, summed over the pod controllers (NOT hashed)
    quarantined: int = 0
    stale_fallbacks: int = 0
    degraded_ticks: int = 0
    frozen_ticks: int = 0
    safe_states: int = 0
    below_axis_clamps: int = 0
    write_nacks: int = 0
    write_retries: int = 0
    watchdog_events: List[str] = dfield(default_factory=list)

    @property
    def fingerprint(self) -> str:
        """Determinism pin — the :attr:`ReplayResult.fingerprint` formula
        verbatim (the degenerate-fleet bitwise contract)."""
        h = hashlib.sha256()
        h.update(self.rails.astype(np.float64).tobytes())
        h.update(np.float64(self.energy_j).tobytes())
        h.update(",".join(self.replan_reasons).encode())
        h.update(np.asarray(sorted(self.condemned), np.int64).tobytes())
        return h.hexdigest()[:16]

    @property
    def fleet_fingerprint(self) -> str:
        """Pod-count-invariance pin: the physical outcome only (applied
        rails, energy, condemned chips) — no per-pod bookkeeping."""
        h = hashlib.sha256()
        h.update(self.rails.astype(np.float64).tobytes())
        h.update(np.float64(self.energy_j).tobytes())
        h.update(np.asarray(sorted(self.condemned), np.int64).tobytes())
        return h.hexdigest()[:16]


def fleet_replay(scenario: Scenario, n_pods: int = 2,
                 runtime: Optional[RT.EnergyAwareRuntime] = None,
                 tick_s: float = 60.0, guard_band_c: float = 3.0,
                 sweep=(10.0, 45.0, 8), util_sweep=(0.25, 1.0, 4),
                 faults=None, amb_offset_c: float = 0.0,
                 write_latency_s: float = 0.0,
                 power_budget_w: Optional[float] = None,
                 degrade_after: int = 2, quarantine_after: int = 4,
                 restore_after: int = 3, restore_below_c: float = 70.0,
                 device=None) -> FleetReplayResult:
    """Run ``scenario`` through the §10 multi-pod ``FleetLoop``.

    One ``RailField`` build and one ``FleetPlanner`` serve every pod: each
    pod's ``LutController`` sees a ``slice_chips`` view of the shared
    field over a ``PodPlanner`` facade, its own ``TelemetryBus`` fed by
    ``FanoutTelemetry`` slices of the shared monitor/elastic/fleet sources
    plus its own ambient sensor (pod ``i`` reads
    ``scenario.ambient + i * amb_offset_c``; pod 0 is the machine-room
    reference), and a ``PodRailChannel`` over the shared actuator.

    Chaos: ``scenario.chaos`` (or ``faults``) attaches per pod.  With
    ``scenario.chaos_pod`` set, only that pod's sensors/rails/watchdog see
    the fault plane (the pod-loss drill); otherwise every pod draws its
    own decorrelated stream via ``ControlFaultModel.for_pod``.  With
    ``n_pods=1`` the base model attaches exactly as :func:`replay` does.

    Determinism and invariance (the reference's contracts, held by
    ``tests/test_torch_fleet.py``):

    - ``n_pods=1`` is **bitwise** the flat loop: same polls, same decide,
      same actuator writes — ``fingerprint`` equals the
      :func:`replay` fingerprint on the same runtime/controller config.
    - For clean scenarios (no chaos, no hotspots, no stragglers, zero
      ambient offsets) the physical outcome is **pod-count invariant**:
      the per-tick fleet utilization is assembled before any pod decides,
      replans are memoized per ``(t_amb, util)`` so every pod slices ONE
      shared solve, and the bilinear RailField lookup commutes with chip
      slicing — ``fleet_fingerprint`` is the same for any pod count.
      Scenarios with per-pod fault streams, hotspots, or stragglers are
      *not* invariant (a pod slice changes which controller sees the hot
      chip and decorrelated NACK draws land in different order); their
      multi-pod fingerprints are pinned as their own golden values.

    Without ``runtime`` one is built on ``device`` (``None`` is the CUDA
    card).
    """
    rt = _runtime(runtime, device)
    field = rt.build_field(ctl.sweep_points(*sweep),
                           ctl.sweep_points(*util_sweep))
    chips = rt.substrate.n_domains
    spans = PodTopology.partition(chips, n_pods)
    topo = PodTopology(grid=rt.substrate.grid)

    det = StragglerDetector(threshold=1.5, window=8, min_samples=4)
    mon = ctl.MonitorTelemetry(det, topology=topo)
    assignment = ElasticWorkAssignment(chips)
    elastic = ElasticActuator(assignment)
    fleet = ctl.FleetActuator.from_runtime(
        rt, t_amb=scenario.ambient_at(0), field=field)
    if faults is None and scenario.chaos is not None:
        faults = scenario.chaos()
    if n_pods == 1 and faults is not None:
        fleet.write_faults = faults  # the flat loop's exact wiring

    ctx = ctl.TickContext()
    mon_f = ctl.FanoutTelemetry(mon)
    ela_f = ctl.FanoutTelemetry(elastic)
    flt_f = ctl.FanoutTelemetry(fleet)
    pods: List[ctl.PodDomain] = []
    for i, (lo, hi) in enumerate(spans):
        pf = None
        if faults is not None and (scenario.chaos_pod is None
                                   or scenario.chaos_pod == i):
            pf = faults if n_pods == 1 else faults.for_pod(i)
        planner = ctl.PodPlanner(rt.planner, lo, hi, ctx=ctx)
        controller = ctl.LutController(
            planner,
            field=field if n_pods == 1 else field.slice_chips(lo, hi),
            guard_band_c=guard_band_c)
        trace = (scenario.ambient if i == 0 or amb_offset_c == 0.0 else
                 (lambda now, off=i * amb_offset_c:
                  scenario.ambient(now) + off))
        amb_src = ctl.AmbientSensor(trace)
        flt_src = flt_f.view(lo, hi, primary=(i == 0))
        ch_kw = {}
        if pf is not None:
            amb_src = ctl.ChaosTelemetry(amb_src, pf)
            flt_src = ctl.ChaosTelemetry(flt_src, pf)
            controller.faults = pf  # scripted deadline/solver-fault ticks
            if n_pods > 1:
                ch_kw["write_faults"] = pf  # slice-confined NACK channel
        bus = ctl.TelemetryBus(
            [amb_src, _LoadTelemetry(scenario),
             mon_f.view(lo, hi, primary=(i == 0)),
             ela_f.view(lo, hi, primary=(i == 0)), flt_src],
            max_age=0.75 if faults is not None else None)
        pods.append(ctl.PodDomain(
            index=i, lo=lo, hi=hi, bus=bus, controller=controller,
            rails=ctl.PodRailChannel(fleet, lo, hi,
                                     write_latency_s=write_latency_s,
                                     **ch_kw)))
    loop = ctl.FleetLoop(pods, fleet, elastic=elastic, ctx=ctx,
                         power_budget_w=power_budget_w,
                         degrade_after=degrade_after,
                         quarantine_after=quarantine_after,
                         restore_after=restore_after,
                         restore_below_c=restore_below_c)
    for pod in pods:
        pod.controller.reset()
    bases = []
    for pod in pods:
        st = pod.controller.stats
        bases.append((st.replans, st.lut_hits, st.boosts, st.rebalances,
                      len(st.replan_reasons), st.quarantined,
                      st.stale_fallbacks, st.degraded_ticks,
                      st.frozen_ticks, st.safe_states,
                      st.below_axis_clamps, len(st.watchdog_events)))

    steps_by_tick = _by_tick(scenario.steps)
    hot_by_tick = _by_tick(scenario.hotspots)

    rails = np.zeros((scenario.ticks, 2, chips), np.float32)
    savings, powers, t_maxes = [], [], []
    state_trace: List[Dict[int, str]] = []
    for tick in range(scenario.ticks):
        for rec in steps_by_tick.get(tick, ()):
            mon.record_step(rec.worker, tick, rec.step_s)
        for h in hot_by_tick.get(tick, ()):
            fleet.set_temps(h.chip, h.t_chip)
        rep = loop.step(now=float(tick))
        rails[tick, 0] = fleet.v_core
        rails[tick, 1] = fleet.v_sram
        ro = rep.readout
        savings.append(ro.saving)
        powers.append(ro.pod_power_w)
        t_maxes.append(ro.t_max)
        state_trace.append(dict(rep.states))

    agg = [0] * 12
    reasons: List[str] = []
    watchdog: List[str] = []
    for pod, base in zip(pods, bases):
        st = pod.controller.stats
        cur = (st.replans, st.lut_hits, st.boosts, st.rebalances,
               len(st.replan_reasons), st.quarantined, st.stale_fallbacks,
               st.degraded_ticks, st.frozen_ticks, st.safe_states,
               st.below_axis_clamps, len(st.watchdog_events))
        agg = [a + (c - b) for a, (c, b) in zip(agg, zip(cur, base))]
        reasons.extend(st.replan_reasons[base[4]:])
        watchdog.extend(f"pod{pod.index}:{e}" if n_pods > 1 else e
                        for e in st.watchdog_events[base[11]:])
    return FleetReplayResult(
        name=scenario.name, ticks=scenario.ticks, n_pods=n_pods,
        replans=agg[0], lut_hits=agg[1], boosts=agg[2], rebalances=agg[3],
        replan_reasons=reasons,
        mean_saving=float(np.mean(savings)),
        energy_j=float(np.sum(powers) * tick_s),
        t_max=float(np.max(t_maxes)),
        condemned=tuple(sorted(assignment.condemned)),
        shares=assignment.shares.copy(), rails=rails,
        states={p.index: p.state for p in pods},
        state_trace=state_trace, events=list(loop.events),
        migrated=loop.migrated_total,
        quarantines=sum(1 for e in loop.events if ":quarantined@" in e),
        pod_restores=sum(1 for e in loop.events if ":restored@" in e),
        staged_commits=sum(p.rails.staged_commits for p in pods),
        quarantined=agg[5], stale_fallbacks=agg[6], degraded_ticks=agg[7],
        frozen_ticks=agg[8], safe_states=agg[9], below_axis_clamps=agg[10],
        write_nacks=fleet.write_nacks, write_retries=fleet.write_retries,
        watchdog_events=watchdog)


# ---------------------------------------------------------------------------
# serving replay harness (engine in the loop)
# ---------------------------------------------------------------------------


@dataclass
class ServeReplayResult:
    """One served day: traffic, energy and SLO ledger."""
    name: str
    workload: str
    ticks: int               # control ticks actually run (incl. drain)
    engine_ticks: int
    finished: int
    rejected: int            # prompt_too_long etc.
    tokens: int              # generated tokens across finished requests
    energy_j: float          # sum(pod_power_w) * tick_s over control ticks
    max_wait: float          # engine ticks, submit -> finish (worst case)
    mean_wait: float
    caps: np.ndarray         # (ticks,) applied admit cap (-1 = uncapped)
    outputs: Tuple[Tuple[int, ...], ...]  # rid-ordered generated tokens
    deferred: int = 0        # AdmissionController ledger (0 for baselines)
    forced: int = 0
    preempts: int = 0        # slot evictions to the host page pool
    preempted_reqs: int = 0  # distinct requests that were evicted
    model_ticks: int = 0     # engine ticks that ran a model step
    # §10 fleet ledger (0 unless run through fleet_serve_replay)
    migrated: int = 0        # requests live-migrated across pods
    quarantines: int = 0     # pods walked to quarantine
    pod_restores: int = 0    # pods restored through the cool-down

    @property
    def tokens_per_joule(self) -> float:
        return self.tokens / self.energy_j if self.energy_j > 0 else 0.0


def serve_prompt(rid: int, prompt_len: int, vocab: int) -> np.ndarray:
    """The deterministic prompt for a workload rid (pure function of the
    arrival record)."""
    return ((np.arange(prompt_len, dtype=np.int64) * 3 + rid * 7) % vocab
            ).astype(np.int32)


def serve_replay(scenario: Scenario, workload: RequestWorkload, model,
                 controller=None,
                 runtime: Optional[RT.EnergyAwareRuntime] = None,
                 admission: bool = False, defer_premium: float = 1.05,
                 max_wait: Optional[float] = None, preempt: bool = False,
                 engine_steps: int = 6, tick_s: float = 60.0,
                 sweep=(10.0, 45.0, 4), util_sweep=(0.25, 1.0, 4),
                 batch_slots: int = 4, max_len: int = 64,
                 drain_ticks: int = 32, engine_seed: int = 0,
                 device=None, **engine_kwargs) -> ServeReplayResult:
    """Run a request workload through a real serve ``Engine`` on ``model``
    (a :class:`repro_torch.models.model.Model`, on its own device) under
    the full control loop; deterministic.

    Each control tick: the tick's arrivals are submitted, the engine runs
    ``engine_steps`` scheduler iterations (emitting ``TickSample``\\ s), then
    the control loop polls/decides/settles — so ``Throttle`` decisions made
    from this tick's queue state gate the *next* tick's admissions, and the
    energy ledger integrates the settled pod power at the utilization the
    engine actually ran.

    ``admission=True`` wraps the rail controller in an
    :class:`~repro_torch.control.admission.AdmissionController`
    (thermal-aware admission); the default is the throughput-only baseline
    (same rails, uncapped admission). Pass a prebuilt ``controller`` to
    override both. Without ``runtime`` one is built on ``device`` (``None``
    is the CUDA card). After the scenario's day the loop keeps ticking
    until the engine drains or ``drain_ticks`` elapse.
    """
    from repro_torch.serve import Engine, Request

    rt = _runtime(runtime, device)
    if controller is None:
        controller = rt.controller(
            field=rt.build_field(ctl.sweep_points(*sweep),
                                 ctl.sweep_points(*util_sweep)),
            guard_band_c=3.0)
        if admission:
            controller = ctl.AdmissionController(
                controller, defer_premium=defer_premium,
                max_wait=(max_wait if max_wait is not None
                          else 4.0 * engine_steps * scenario.ticks),
                preempt=preempt)
    if hasattr(controller, "reset"):
        controller.reset()

    eng = Engine(model, batch_slots=batch_slots, max_len=max_len,
                 seed=engine_seed, **engine_kwargs)
    adm = isinstance(controller, ctl.AdmissionController)
    if adm:
        eng.admit_cap = 0  # the controller owns the knob from tick 0
    tel = ctl.EngineTelemetry()
    eng.on_tick.append(tel.on_tick)
    widths: List[int] = []
    eng.on_tick.append(lambda smp: widths.append(eng.tick_width))
    fleet = ctl.FleetActuator.from_runtime(
        rt, t_amb=scenario.ambient_at(0),
        field=getattr(controller, "field", None))
    loop = ctl.ControlLoop(
        ctl.TelemetryBus([ctl.AmbientSensor(scenario.ambient), tel, fleet]),
        controller, [fleet, ctl.EngineActuator(eng)])

    stats = controller.stats if adm else None
    base_def, base_forced = ((stats.deferred, stats.forced) if adm
                             else (0, 0))
    vocab = model.cfg.vocab_size
    by_tick = workload.by_tick()
    hot_by_tick = _by_tick(scenario.hotspots)
    reqs: Dict[int, Request] = {}
    powers: List[float] = []
    caps: List[int] = []
    tick = 0
    while tick < scenario.ticks or (
            tick < scenario.ticks + drain_ticks
            and (eng.queue or any(r is not None for r in eng.slot_req))):
        for a in by_tick.get(tick, ()):
            req = Request(a.rid, serve_prompt(a.rid, a.prompt_len, vocab),
                          max_new=a.max_new)
            reqs[a.rid] = req
            eng.submit(req)
        for _ in range(engine_steps):
            eng.step()
        for h in hot_by_tick.get(tick, ()):
            fleet.set_temps(h.chip, h.t_chip)  # cooling fault, live traffic
        rep = loop.step(now=float(tick))
        powers.append(rep.readout.pod_power_w)
        caps.append(-1 if eng.admit_cap is None else int(eng.admit_cap))
        tick += 1

    ok = [r for r in eng.finished if r.error is None]
    waits = [float(r.finish_tick - r.submit_tick) for r in ok]
    return ServeReplayResult(
        name=scenario.name, workload=workload.name, ticks=tick,
        engine_ticks=eng.ticks, finished=len(ok),
        rejected=len(eng.finished) - len(ok),
        tokens=sum(len(r.out) for r in ok),
        energy_j=float(np.sum(powers) * tick_s),
        max_wait=float(max(waits)) if waits else 0.0,
        mean_wait=float(np.mean(waits)) if waits else 0.0,
        caps=np.asarray(caps, np.int64),
        outputs=tuple(tuple(reqs[rid].out) for rid in sorted(reqs)),
        deferred=stats.deferred - base_def if adm else 0,
        forced=stats.forced - base_forced if adm else 0,
        preempts=eng.preempts,
        preempted_reqs=sum(1 for r in reqs.values() if r.preempts > 0),
        model_ticks=sum(w > 0 for w in widths))


def fleet_serve_replay(scenario: Scenario, workload: RequestWorkload,
                       model, n_pods: int = 2,
                       runtime: Optional[RT.EnergyAwareRuntime] = None,
                       engine_steps: int = 6, tick_s: float = 60.0,
                       sweep=(10.0, 45.0, 4), util_sweep=(0.25, 1.0, 4),
                       guard_band_c: float = 3.0, batch_slots: int = 4,
                       max_len: int = 64, drain_ticks: int = 32,
                       engine_seed: int = 0, faults=None,
                       degrade_after: int = 2, quarantine_after: int = 4,
                       restore_after: int = 3, restore_below_c: float = 70.0,
                       power_budget_w: Optional[float] = None,
                       enforce_budget: bool = False, device=None,
                       **engine_kwargs) -> ServeReplayResult:
    """The §10 pod-loss serving drill: a request workload served by
    ``n_pods`` engines on ``model`` (one per failure domain, the weights
    shared) over ONE shared :class:`~repro_torch.serve.cache.HostPagePool`,
    under the fleet health machine. When a pod is quarantined its engine is
    drained — active slots evicted page-exact to the shared pool — and
    every in-flight request is live-migrated to the survivors' engines,
    which restore its parked KV rows and go on with its prompt chunks or
    its greedy decode: ``outputs`` equals the no-failure day's outputs, rid
    for rid (held by ``tests/test_torch_fleet.py``).

    Arrivals are routed ``rid % len(live_pods)`` over the pods currently
    accepting work — deterministic, and a drained pod rejoins the rotation
    the tick it is restored. Without ``runtime`` one is built on ``device``
    (``None`` is the CUDA card); the model runs on its own device.
    """
    from repro_torch.serve import Engine, Request
    from repro_torch.serve.cache import HostPagePool

    rt = _runtime(runtime, device)
    field = rt.build_field(ctl.sweep_points(*sweep),
                           ctl.sweep_points(*util_sweep))
    chips = rt.substrate.n_domains
    spans = PodTopology.partition(chips, n_pods)
    assignment = ElasticWorkAssignment(chips)
    elastic = ElasticActuator(assignment)
    fleet = ctl.FleetActuator.from_runtime(
        rt, t_amb=scenario.ambient_at(0), field=field)
    if faults is None and scenario.chaos is not None:
        faults = scenario.chaos()
    if n_pods == 1 and faults is not None:
        fleet.write_faults = faults

    pool = HostPagePool()  # ONE host pool: the migration fabric
    widths: List[int] = []  # every engine's tick widths
    ctx = ctl.TickContext()
    ela_f = ctl.FanoutTelemetry(elastic)
    flt_f = ctl.FanoutTelemetry(fleet)
    pods: List[ctl.PodDomain] = []
    for i, (lo, hi) in enumerate(spans):
        pf = None
        if faults is not None and (scenario.chaos_pod is None
                                   or scenario.chaos_pod == i):
            pf = faults if n_pods == 1 else faults.for_pod(i)
        eng = Engine(model, batch_slots=batch_slots, max_len=max_len,
                     seed=engine_seed, pool=pool, **engine_kwargs)
        tel = ctl.EngineTelemetry()
        eng.on_tick.append(tel.on_tick)
        eng.on_tick.append(lambda smp, e=eng: widths.append(e.tick_width))
        controller = ctl.LutController(
            ctl.PodPlanner(rt.planner, lo, hi, ctx=ctx),
            field=field if n_pods == 1 else field.slice_chips(lo, hi),
            guard_band_c=guard_band_c)
        amb_src = ctl.AmbientSensor(scenario.ambient)
        flt_src = flt_f.view(lo, hi, primary=(i == 0))
        ch_kw = {}
        if pf is not None:
            amb_src = ctl.ChaosTelemetry(amb_src, pf)
            flt_src = ctl.ChaosTelemetry(flt_src, pf)
            controller.faults = pf
            if n_pods > 1:
                ch_kw["write_faults"] = pf
        bus = ctl.TelemetryBus(
            [amb_src, tel, ela_f.view(lo, hi, primary=(i == 0)), flt_src],
            max_age=0.75 if faults is not None else None)
        pods.append(ctl.PodDomain(
            index=i, lo=lo, hi=hi, bus=bus, controller=controller,
            rails=ctl.PodRailChannel(fleet, lo, hi, **ch_kw),
            engine=eng, extra=[ctl.EngineActuator(eng)]))
    loop = ctl.FleetLoop(pods, fleet, elastic=elastic, ctx=ctx,
                         power_budget_w=power_budget_w,
                         enforce_budget=enforce_budget,
                         degrade_after=degrade_after,
                         quarantine_after=quarantine_after,
                         restore_after=restore_after,
                         restore_below_c=restore_below_c)
    for pod in pods:
        pod.controller.reset()

    def live():
        return [p for p in pods if p.state in (ctl.HEALTHY, ctl.DEGRADED)]

    vocab = model.cfg.vocab_size
    by_tick = workload.by_tick()
    hot_by_tick = _by_tick(scenario.hotspots)
    reqs: Dict[int, Request] = {}
    powers: List[float] = []
    caps: List[int] = []

    def busy():
        return any(p.engine.queue
                   or any(r is not None for r in p.engine.slot_req)
                   for p in pods)

    tick = 0
    while tick < scenario.ticks or (tick < scenario.ticks + drain_ticks
                                    and busy()):
        targets = live()
        for a in by_tick.get(tick, ()):
            req = Request(a.rid, serve_prompt(a.rid, a.prompt_len, vocab),
                          max_new=a.max_new)
            reqs[a.rid] = req
            targets[a.rid % len(targets)].engine.submit(req)
        for p in pods:
            if p.state in (ctl.HEALTHY, ctl.DEGRADED):
                for _ in range(engine_steps):
                    p.engine.step()
        for h in hot_by_tick.get(tick, ()):
            fleet.set_temps(h.chip, h.t_chip)
        rep = loop.step(now=float(tick))
        powers.append(rep.readout.pod_power_w)
        pod_caps = [p.engine.admit_cap for p in live()]
        applied = [c for c in pod_caps if c is not None]
        caps.append(min(applied) if applied else -1)
        tick += 1

    ok = [r for p in pods for r in p.engine.finished if r.error is None]
    bad = [r for p in pods for r in p.engine.finished
           if r.error is not None]
    waits = [float(r.finish_tick - r.submit_tick) for r in ok]
    outputs = tuple(tuple(reqs[rid].out) for rid in sorted(reqs))
    return ServeReplayResult(
        name=scenario.name, workload=workload.name, ticks=tick,
        engine_ticks=sum(p.engine.ticks for p in pods),
        finished=len(ok), rejected=len(bad),
        tokens=sum(len(r.out) for r in ok),
        energy_j=float(np.sum(powers) * tick_s),
        max_wait=float(max(waits)) if waits else 0.0,
        mean_wait=float(np.mean(waits)) if waits else 0.0,
        caps=np.asarray(caps, np.int64), outputs=outputs,
        preempts=sum(p.engine.preempts for p in pods),
        preempted_reqs=sum(1 for r in reqs.values() if r.preempts > 0),
        model_ticks=sum(w > 0 for w in widths),
        migrated=loop.migrated_total,
        quarantines=sum(1 for e in loop.events if ":quarantined@" in e),
        pod_restores=sum(1 for e in loop.events if ":restored@" in e))


# ---------------------------------------------------------------------------
# CLI smoke: python -m repro_torch.scenarios <scenario> [--quick] [--json]
# ---------------------------------------------------------------------------


def _main(argv=None) -> int:
    import argparse
    import json
    import time

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.scenarios",
        description="replay one scenario twice and verify the determinism "
                    "pin (same fingerprint) and the thermal envelope")
    ap.add_argument("scenario", choices=sorted(SCENARIOS))
    ap.add_argument("--quick", action="store_true",
                    help="16-tick day on a coarse sweep (CI smoke)")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default=None,
                    help="where the planner and the settle run (default: "
                         "the CUDA card; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    sc = SCENARIOS[args.scenario](ticks=16) if args.quick \
        else SCENARIOS[args.scenario]()
    rt = _runtime(None, args.device)
    sweep = (15.0, 40.0, 4) if args.quick else (10.0, 45.0, 8)
    u_knots = (0.25, 1.0, 3 if args.quick else 4)
    if args.scenario == "pod_loss_day":
        # the §10 drill replays through the multi-pod FleetLoop: verify
        # determinism AND that the day actually walked a pod through
        # quarantine and back
        kw = dict(n_pods=2, runtime=rt, sweep=sweep, util_sweep=u_knots)
        a = fleet_replay(sc, **kw)
        b = fleet_replay(sc, **kw)
        assert a.fingerprint == b.fingerprint, \
            f"fleet replay not deterministic: {a.fingerprint} != " \
            f"{b.fingerprint}"
        assert a.t_max < TF.T_MAX_CHIP, \
            f"thermal envelope violated: {a.t_max:.1f}C >= {TF.T_MAX_CHIP}C"
        assert a.quarantines >= 1, f"no pod quarantined: {a.events}"
        assert a.pod_restores >= 1, f"no pod restored: {a.events}"
        out = {
            "scenario": a.name, "ticks": a.ticks, "n_pods": a.n_pods,
            "fingerprint": a.fingerprint, "replans": a.replans,
            "mean_saving": round(a.mean_saving, 4),
            "t_max": round(a.t_max, 2), "states": a.states,
            "quarantines": a.quarantines, "pod_restores": a.pod_restores,
            "condemned": list(a.condemned), "events": a.events,
            "wall_s": time.perf_counter() - t0,
        }
        if args.json:
            print(json.dumps(out, indent=2))
        else:
            print(f"[{out['scenario']}] deterministic over {out['ticks']} "
                  f"ticks x {out['n_pods']} pods "
                  f"(fingerprint {out['fingerprint']})")
            for k in ("replans", "mean_saving", "t_max", "states",
                      "quarantines", "pod_restores", "wall_s"):
                print(f"  {k:>22}: {out[k]}")
            for e in out["events"]:
                print(f"  {'event':>22}: {e}")
        return 0
    controller = rt.controller(
        field=rt.build_field(ctl.sweep_points(*sweep),
                             ctl.sweep_points(*u_knots)),
        guard_band_c=3.0)
    a = replay(sc, runtime=rt, controller=controller)
    b = replay(sc, runtime=rt, controller=controller)
    assert a.fingerprint == b.fingerprint, \
        f"replay not deterministic: {a.fingerprint} != {b.fingerprint}"
    assert a.t_max < TF.T_MAX_CHIP, \
        f"thermal envelope violated: {a.t_max:.1f}C >= {TF.T_MAX_CHIP}C"
    out = {
        "scenario": a.name, "ticks": a.ticks, "fingerprint": a.fingerprint,
        "replans": a.replans, "lut_hits": a.lut_hits,
        "mean_saving": round(a.mean_saving, 4), "t_max": round(a.t_max, 2),
        "quarantined": a.quarantined, "stale_fallbacks": a.stale_fallbacks,
        "degraded_ticks": a.degraded_ticks, "frozen_ticks": a.frozen_ticks,
        "safe_states": a.safe_states, "write_nacks": a.write_nacks,
        "below_axis_clamps": a.below_axis_clamps,
        "watchdog_events": a.watchdog_events,
        "mean_ticks_to_recover": a.mean_ticks_to_recover,
        "wall_s": time.perf_counter() - t0,
    }
    if args.json:
        print(json.dumps(out, indent=2))
    else:
        print(f"[{out['scenario']}] deterministic over {out['ticks']} ticks"
              f" (fingerprint {out['fingerprint']})")
        for k in ("replans", "lut_hits", "mean_saving", "t_max",
                  "quarantined", "stale_fallbacks", "degraded_ticks",
                  "frozen_ticks", "safe_states", "write_nacks",
                  "below_axis_clamps", "mean_ticks_to_recover", "wall_s"):
            print(f"  {k:>22}: {out[k]}")
        if out["watchdog_events"]:
            print(f"  {'watchdog_events':>22}: "
                  + ", ".join(out["watchdog_events"]))
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
