"""Replayable serving days (the serving half of the reference's
``repro/scenarios.py``).

- a :class:`Scenario` is pure data: an ambient trace and optional hotspot
  injections (a failed fan / blocked airflow on one chip);
- a :class:`RequestWorkload` is a deterministic arrival trace
  (:func:`trace_requests`, :func:`poisson_requests`, :func:`poisson_burst`);
- :func:`serve_replay` runs a workload through a real serve ``Engine``
  under the full telemetry -> controller -> actuator loop and returns a
  :class:`ServeReplayResult` with the decisions (the admission-cap trace,
  deferrals, preemptions), the energy ledger and the generated tokens.

The planner's fixed points and the fleet actuator's thermal settle run on
the runtime's device (``device=None`` is the CUDA card); the model runs on
its own device. Same trace -> same decisions: the scheduler does not read
the tokens (``eos_id=-1`` runs every request to ``max_new``), so the cap
trace and the counts do not depend on the model's width.

(``replay``, ``fleet_replay``, the named control-plane days and
``fleet_serve_replay`` come with the fleet, fault and ``ft`` slice.)
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch import control as ctl
from repro_torch.core import runtime as RT
from repro_torch.core import tpu_fleet as TF

# ---------------------------------------------------------------------------
# scenario data model
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Hotspot:
    """A localized cooling fault: chip ``chip`` reads ``t_chip`` degC at
    ``tick`` (failed fan, blocked airflow)."""
    tick: int
    chip: int
    t_chip: float


@dataclass(frozen=True)
class Scenario:
    """A served day. (The reference's scenario also scripts a load trace,
    worker step times, SDC noise and control-plane chaos for ``replay``;
    those fields come with the slice that ports it.)"""
    name: str
    ticks: int
    ambient: Callable[[float], float]
    hotspots: Tuple[Hotspot, ...] = ()
    description: str = ""

    def ambient_at(self, tick: int) -> float:
        return float(self.ambient(float(tick)))


def serve_day(ticks: int = 14, hot: float = 42.0, cool: float = 12.0,
              cool_at: int = 7) -> Scenario:
    """The serving acceptance day (§8): a hot window (peak ambient, rails
    near nominal) followed by a machine-room cool-down. Tokens served
    during the hot window cost more joules than the same tokens after the
    cool-down — the intertemporal arbitrage the thermal-aware admission
    controller prices."""
    return Scenario(
        name="serve_day", ticks=ticks,
        ambient=lambda now: hot if now < cool_at else cool,
        description=f"hot window {hot}C, cool-down to {cool}C at {cool_at}")


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

    rt = runtime if runtime is not None else RT.EnergyAwareRuntime(
        TF.StepProfile.from_roofline(compute_s=0.8, memory_s=0.45,
                                     collective_s=0.2),
        policy="power_save", device=device)
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
    hot_by_tick: Dict[int, List[Hotspot]] = {}
    for h in scenario.hotspots:
        hot_by_tick.setdefault(h.tick, []).append(h)
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
