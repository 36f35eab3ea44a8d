"""control.fleet — hierarchical multi-pod control with failure domains.

The port of ``repro.control.fleet`` (the health machine, the telemetry
fan-out and the rail channels are host-side, as the reference's; the one
shared replan per tick and the one global settle run on the runtime's
device through the planner and the fleet actuator). A
:class:`~repro_torch.control.loop.ControlLoop` drives ONE pod; this module
scales the loop to multi-pod fleets without giving up the single-pod
guarantees (DESIGN.md §10):

hierarchy (the VolTune split, one level up)
    One **global planner** (the shared :class:`~repro_torch.control.planner.
    FleetPlanner` plus this module's power budgeting) over N **per-pod
    fast loops**.  Each pod owns a :class:`~repro_torch.control.controller.
    LutController` whose :class:`~repro_torch.control.lut.RailField` is a
    ``slice_chips`` view of ONE fleet-wide field build, a
    :class:`PodRailChannel` addressing only its chip slice of the shared
    rail actuator, and its own :class:`~repro_torch.control.telemetry.
    TelemetryBus` fed by :class:`FanoutTelemetry` slices of the shared
    sources plus its own ambient sensor.

failure domains
    A pod is the containment unit.  Per-pod watchdog ladders escalate
    independently (one pod's solver divergence never freezes a sibling's
    rails); the fleet-level health machine aggregates each pod's fault
    signals into ``healthy -> degraded -> quarantined -> drained`` and
    back.  Quarantine freezes the pod's rails at nominal safe state,
    migrates its work share to the survivors (``ElasticWorkAssignment``),
    and live-migrates its in-flight serve requests through the shared
    :class:`~repro_torch.serve.cache.HostPagePool` — page-exact eviction,
    so a request resumed on a healthy pod decodes bitwise what it would
    have decoded at home.  A drained pod re-joins through the same cool-down
    hysteresis the chip-level restore path uses.

asynchrony
    :class:`PodRailChannel` double-buffers rail writes when
    ``write_latency_s > 0``: a ``SetRails`` staged this tick lands at the
    next tick's ``begin_tick`` (modeled PMBus write latency), so a replan
    in one pod overlaps decode everywhere else and a wedged pod cannot
    stall its siblings — the fleet tick never blocks on a pod's channel.

degenerate guarantee (held by ``tests/test_torch_fleet.py``)
    With ``n_pods=1`` every phase of :meth:`FleetLoop.step` reduces to the
    exact call sequence of ``ControlLoop.step`` — same polls, same
    ``decide``, same ``FleetActuator.apply``/``settle`` — so the single-pod
    fleet replays ``diurnal_load_spike`` and ``chaos_day`` bitwise
    identical to the flat loop.

host syncs
    The health machine reads the host copy of the settled field
    (``FleetActuator.t_chip``), never the device field, so a fleet tick
    reads the device back no more often than the flat loop: once per
    settle, plus the planner's read-back of a replan (one solve per
    environment per tick, shared by every pod).
"""
from __future__ import annotations

import inspect
import time
from dataclasses import dataclass, field as dc_field, replace
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.control.controller import (Action, BoostRail, Rebalance,
                                            Restore, SafeState, SetRails)
from repro_torch.control.loop import LoopReport
from repro_torch.control.lut import DEFAULT_UTIL_KNOTS
from repro_torch.control.planner import PlanOut
from repro_torch.control.telemetry import (ChipTempSample, SafeStateSample,
                                           Sample, SdcSample, Snapshot,
                                           StragglerSample, TelemetryBus,
                                           UtilSample)
from repro_torch.core import tpu_fleet as TF

# pod health states (the §10 containment ladder)
HEALTHY = "healthy"
DEGRADED = "degraded"
QUARANTINED = "quarantined"
DRAINED = "drained"

_UNSET = object()  # PodRailChannel: "inherit the actuator's fault model"


# ---------------------------------------------------------------------------
# per-pod rail write channel
# ---------------------------------------------------------------------------


class PodRailChannel:
    """One pod's rail write channel over the shared :class:`FleetActuator`.

    Translates slice-width ``SetRails`` (the pod controller plans only its
    own chips) into writes on the fleet actuator's ``[lo, hi)`` chip slice,
    preserving straggler boost overrides and safe-state pins exactly like
    the full-width legacy path.  A channel covering the whole fleet
    (``full``) delegates to ``FleetActuator.apply`` verbatim — the
    single-pod degenerate case is bitwise the flat loop.

    ``write_latency_s > 0`` arms the double buffer: ``apply`` stages the
    write (latest wins) and ``begin_tick`` commits it once the modeled
    PMBus latency has elapsed, so one pod's in-flight write never serializes
    against a sibling's tick.

    ``write_faults`` (default: inherit) swaps the actuator's NACK model for
    this slice's writes only — chaos confined to one pod's rail channel.
    """

    def __init__(self, fleet, lo: int, hi: int,
                 write_latency_s: float = 0.0, write_faults=_UNSET):
        self.fleet = fleet
        self.lo, self.hi = int(lo), int(hi)
        if not 0 <= self.lo < self.hi <= fleet.substrate.n_domains:
            raise ValueError(f"chip slice [{lo}, {hi}) outside the fleet's "
                             f"{fleet.substrate.n_domains} chips")
        self.write_latency_s = float(write_latency_s)
        self.write_faults = write_faults
        self._now = 0.0
        self._staged = None  # (SetRails, staged_at)
        self.staged_commits = 0

    @property
    def width(self) -> int:
        return self.hi - self.lo

    @property
    def full(self) -> bool:
        return self.lo == 0 and self.hi == self.fleet.substrate.n_domains

    # ------------------------------------------------------------------
    def begin_tick(self, now: float) -> None:
        # commit the back buffer BEFORE adopting the new tick time: a write
        # staged at tick t lands at the first tick >= t + latency, clocked
        # as a write of THIS tick (the fault windows see the landing time)
        if (self._staged is not None
                and now - self._staged[1] >= self.write_latency_s):
            action, _ = self._staged
            self._staged = None
            self.staged_commits += 1
            self._land(action)
        self._now = float(now)

    def apply(self, action: Action) -> bool:
        if isinstance(action, SetRails):
            if self.write_latency_s > 0.0:
                self._staged = (action, self._now)  # latest write wins
                return True
            self._land(action)
            return True
        # chip-carrying actions arrive fleet-globalized (FleetLoop); the
        # shared actuator applies the ones it understands
        return self.fleet.apply(action)

    def _land(self, action: SetRails) -> None:
        swap = (self.write_faults is not _UNSET
                and self.write_faults is not self.fleet.write_faults)
        if swap:
            prev = self.fleet.write_faults
            self.fleet.write_faults = self.write_faults
        try:
            if self.full:
                self.fleet.apply(action)  # legacy full-width path, bitwise
                return
            vc = np.broadcast_to(np.asarray(action.v_core, np.float32),
                                 (self.width,)).copy()
            vs = np.broadcast_to(np.asarray(action.v_sram, np.float32),
                                 (self.width,)).copy()
            for c in self.fleet.boosted:  # boosts survive field rewrites
                if self.lo <= c < self.hi:
                    bc, bs = self.fleet._boost_rails.get(
                        c, (TF.V_CORE_NOM, TF.V_SRAM_NOM))
                    vc[c - self.lo] = bc
                    vs[c - self.lo] = bs
            self.fleet._program(vc, vs,
                                chips=np.arange(self.lo, self.hi))
        finally:
            if swap:
                self.fleet.write_faults = prev

    def freeze_safe(self) -> None:
        """Quarantine containment: drop any staged write and pin every
        chip of the slice to nominal safe-state rails until restore."""
        self._staged = None
        for c in range(self.lo, self.hi):
            self.fleet._pin_safe(c)


# ---------------------------------------------------------------------------
# per-pod planner view over the shared FleetPlanner
# ---------------------------------------------------------------------------


class TickContext:
    """Per-fleet-tick shared state: the assembled fleet utilization and
    the replan memo every :class:`PodPlanner` consults.  Cleared by
    :meth:`FleetLoop.step` at the top of each tick."""

    def __init__(self):
        self.util: Optional[np.ndarray] = None
        self.memo: Dict = {}

    def clear(self) -> None:
        self.util = None
        self.memo.clear()


class _PodSubstrate:
    """Duck-typed substrate view: ``n_domains`` is the pod width (all the
    controller reads); everything else passes through to the fleet."""

    def __init__(self, inner, width: int):
        self._inner = inner
        self.n_domains = int(width)

    def __getattr__(self, name):
        return getattr(self._inner, name)


class PodPlanner:
    """One pod's planner facade over the shared :class:`FleetPlanner`.

    The controller talks to a planner sized like its pod
    (``substrate.n_domains == hi - lo``); replans go through the FULL
    fleet solve — a pod cannot plan its slice in isolation, the thermal
    field couples every chip — with this pod's sensed utilization embedded
    into the tick's assembled fleet utilization (:class:`TickContext`).
    Solves are memoized per ``(t_amb, util)`` within a tick, so all pods
    replanning at the same sensed environment (the common case: a fleet-
    wide ambient jump) share ONE solver call and receive bitwise-equal
    slices of the same plan.  The first replanning pod pays the solve with
    *its* warm start; order over pods is deterministic.
    """

    def __init__(self, inner, lo: int, hi: int,
                 ctx: Optional[TickContext] = None):
        self.inner = inner
        self.lo, self.hi = int(lo), int(hi)
        if not 0 <= self.lo < self.hi <= inner.substrate.n_domains:
            raise ValueError(f"chip slice [{lo}, {hi}) outside the fleet's "
                             f"{inner.substrate.n_domains} chips")
        self.substrate = _PodSubstrate(inner.substrate, self.hi - self.lo)
        self.ctx = ctx if ctx is not None else TickContext()

    @property
    def full(self) -> bool:
        return self.lo == 0 and self.hi == self.inner.substrate.n_domains

    # passthroughs the controller / _nominal_plan read
    @property
    def lib(self):
        return self.inner.lib

    @property
    def prof(self):
        return self.inner.prof

    @property
    def policy(self):
        return self.inner.policy

    @property
    def T_last(self):
        return self.inner.T_last

    @T_last.setter
    def T_last(self, v) -> None:  # controller.reset() clears the warm field
        self.inner.T_last = v

    def env(self, t_amb: float, util=None) -> Dict:
        return self.inner.env(t_amb, util)

    def baseline_power(self, env: Dict, **kw) -> np.ndarray:
        return self.inner.baseline_power(env, **kw)

    # ------------------------------------------------------------------
    def _embed(self, util) -> Optional[np.ndarray]:
        """This pod's sensed utilization embedded in the tick's fleet
        utilization (ones where nothing was sensed)."""
        base = self.ctx.util
        if base is None and util is None:
            return None
        n = self.inner.substrate.n_domains
        full = (np.ones(n, np.float32) if base is None
                else np.asarray(base, np.float32).copy())
        if util is not None:
            full[self.lo:self.hi] = np.asarray(util, np.float32)
        return full

    def plan_at(self, t_amb: float, util=None, T0=None):
        if self.full:
            return self.inner.plan_at(t_amb, util, T0=T0)
        u = self._embed(util)
        key = (float(t_amb), None if u is None else u.tobytes())
        if key not in self.ctx.memo:
            self.ctx.memo[key] = self.inner.plan_at(t_amb, u, T0=T0)
        plan, T = self.ctx.memo[key]
        # the pod keeps the FULL converged field as its warm start —
        # exactly what the shared solver wants back next replan
        return self._slice(plan), T

    def _slice(self, plan: PlanOut) -> PlanOut:
        lo, hi = self.lo, self.hi
        p = np.asarray(plan.power_w)[lo:hi]
        return PlanOut(
            v_core=np.asarray(plan.v_core)[lo:hi],
            v_sram=np.asarray(plan.v_sram)[lo:hi],
            f_rel=np.asarray(plan.f_rel)[lo:hi],
            power_w=p, step_s=plan.step_s,
            pod_power_w=float(p.sum()),
            # thermal/baseline stats stay fleet-global: the pod's sanity
            # checks (t_max bounds) must see the coupled field, not a
            # slice that happens to exclude the hot corner
            baseline_power_w=plan.baseline_power_w,
            saving=plan.saving, t_mean=plan.t_mean, t_max=plan.t_max)

    def mitigate(self, plan: PlanOut, chip: int, T_chip: float) -> Dict:
        # plan is this pod's slice and chip is pod-local: power_w[chip]
        # reads the right chip either way
        return self.inner.mitigate(plan, chip, T_chip)

    def rail_field(self, t_ambs, u_levels=DEFAULT_UTIL_KNOTS, **kw):
        f = self.inner.rail_field(t_ambs, u_levels, **kw)
        return f if self.full else f.slice_chips(self.lo, self.hi)


# ---------------------------------------------------------------------------
# shared-source fan-out telemetry
# ---------------------------------------------------------------------------


class FanoutTelemetry:
    """Poll a shared source ONCE per fleet tick and fan per-pod slices out
    to the pod buses.  The inner poll is memoized on ``now`` — event-like
    sources (straggler monitors) are still drained exactly once per tick
    even though every pod's bus polls its view."""

    def __init__(self, source):
        self.source = source
        self._at: Optional[float] = None
        self._samples: List[Sample] = []

    def _poll(self, now: float) -> List[Sample]:
        if self._at != now:
            self._samples = list(self.source.poll(now))
            self._at = now
        return self._samples

    def view(self, lo: int, hi: int,
             primary: bool = False) -> "PodTelemetryView":
        return PodTelemetryView(self, lo, hi, primary=primary)


class PodTelemetryView:
    """One pod's slice of a fan-out source.

    Chip-indexed samples are sliced and translated to the pod-local frame
    (the pod controller lives in ``[0, width)``); fleet-global event
    samples (SDC counters, unmapped stragglers) are delivered only to the
    ``primary`` view so nothing is double-counted.  The degenerate single
    view (``primary=True`` over the full slice) delivers every sample
    exactly once with identical values — the flat-loop bitwise guarantee.
    """

    def __init__(self, fanout: FanoutTelemetry, lo: int, hi: int,
                 primary: bool = False):
        self.fanout = fanout
        self.lo, self.hi = int(lo), int(hi)
        self.primary = bool(primary)

    def poll(self, now: float) -> List[Sample]:
        out: List[Sample] = []
        for smp in self.fanout._poll(now):
            if isinstance(smp, ChipTempSample):
                out.append(ChipTempSample(
                    np.asarray(smp.t_chip)[self.lo:self.hi],
                    stamp=smp.stamp))
            elif isinstance(smp, UtilSample):
                out.append(UtilSample(
                    np.asarray(smp.shares)[self.lo:self.hi]))
            elif isinstance(smp, SafeStateSample):
                # emitted even when the slice is empty: the pod bus's
                # persistent safe set must CLEAR when the pins clear
                out.append(SafeStateSample(frozenset(
                    c - self.lo for c in smp.chips
                    if self.lo <= c < self.hi)))
            elif isinstance(smp, StragglerSample):
                if self.lo <= smp.chip < self.hi:
                    out.append(StragglerSample(smp.worker, smp.step,
                                               smp.ratio,
                                               smp.chip - self.lo))
                elif smp.chip < 0 and self.primary:
                    out.append(smp)  # unmapped: surfaced once, by pod 0
            elif isinstance(smp, SdcSample):
                if self.primary:
                    out.append(smp)  # fleet counters: never double-count
            else:
                out.append(smp)
        return out


# ---------------------------------------------------------------------------
# the fleet loop
# ---------------------------------------------------------------------------


@dataclass
class PodDomain:
    """One failure domain: chips ``[lo, hi)`` with their own bus,
    controller, rail channel, optional serve engine, and health state."""

    index: int
    lo: int
    hi: int
    bus: TelemetryBus
    controller: object
    rails: PodRailChannel
    engine: object = None  # serve.Engine — migration source AND target
    extra: List = dc_field(default_factory=list)  # per-pod actuators
    # health machine state (owned by FleetLoop)
    state: str = HEALTHY
    bad_ticks: int = 0
    clean_ticks: int = 0
    cool_ticks: int = 0
    safe_prev: int = 0

    def __post_init__(self):
        self._wants_util = "util" in inspect.signature(
            self.controller.decide).parameters

    @property
    def width(self) -> int:
        return self.hi - self.lo


@dataclass
class FleetReport:
    """One fleet tick: the per-pod loop reports plus fleet-level state."""

    now: float
    reports: List[LoopReport]
    readout: object = None  # the global FleetReadout of this tick's settle
    states: Dict[int, str] = dc_field(default_factory=dict)
    events: List[str] = dc_field(default_factory=list)
    pod_power_w: Optional[np.ndarray] = None
    pod_budget_w: Optional[np.ndarray] = None
    migrated: int = 0

    @property
    def snapshot(self) -> Snapshot:
        """Pod 0's snapshot (the machine-room reference sensor) — keeps
        ``LoopReport``-shaped consumers working on the degenerate fleet."""
        return self.reports[0].snapshot

    @property
    def actions(self) -> List[Action]:
        return [a for r in self.reports for a in r.actions]


def _globalize(action: Action, lo: int) -> Action:
    """Translate a pod-local chip index into the fleet frame.  Pod 0
    returns the SAME object — the degenerate path applies the controller's
    actions untouched, like the flat loop."""
    if lo == 0:
        return action
    if isinstance(action, (BoostRail, Rebalance, Restore, SafeState)):
        return replace(action, chip=action.chip + lo)
    return action


class FleetLoop:
    """N per-pod control loops under one global planner/health authority.

    ``step(now)`` runs four phases:

    1. **poll** — every pod's bus polls first (quarantined pods included:
       recovery is judged on their own telemetry), and the tick's fleet
       utilization is assembled, so all pods decide against the same
       world state and share one memoized replan per environment.
    2. **decide + apply** — per pod, in index order: the pod's rail
       channel clocks (committing any latency-staged write), its
       controller decides on its slice snapshot, and the actions — chip
       indices translated to the fleet frame — land on the pod's rail
       channel, the shared elastic actuator, and the pod's extra
       actuators.  Quarantined/drained pods skip this phase entirely:
       their rails stay frozen, their watchdogs cannot stall a sibling.
    3. **settle** — ONE global thermal/power evaluation (the field couples
       every chip; there is exactly one physics).
    4. **health** — per-pod fault signals (bus quarantines, watchdog
       level, safe-state growth) drive ``healthy -> degraded ->
       quarantined -> drained`` and the cool-down restore; quarantine
       freezes rails, migrates work shares and live serve requests to the
       survivors; the optional fleet power budget re-shares over the
       remaining healthy pods.
    """

    def __init__(self, pods: Sequence[PodDomain], fleet,
                 elastic=None, ctx: Optional[TickContext] = None,
                 tick_deadline_s: Optional[float] = None,
                 power_budget_w: Optional[float] = None,
                 enforce_budget: bool = False,
                 degrade_after: int = 2, quarantine_after: int = 4,
                 restore_after: int = 3, restore_below_c: float = 70.0):
        self.pods = list(pods)
        self.fleet = fleet
        self.elastic = elastic
        self.ctx = ctx if ctx is not None else TickContext()
        self.tick_deadline_s = tick_deadline_s
        self.power_budget_w = power_budget_w
        self.enforce_budget = bool(enforce_budget)
        self.degrade_after = max(int(degrade_after), 1)
        self.quarantine_after = max(int(quarantine_after), 1)
        self.restore_after = max(int(restore_after), 1)
        self.restore_below_c = float(restore_below_c)
        self.deadline_misses = 0
        self.migrated_total = 0
        self.events: List[str] = []
        self.history: List[FleetReport] = []
        self._rr = 0  # migration round-robin cursor (deterministic)
        n = fleet.substrate.n_domains
        cur = 0
        for pod in self.pods:
            if pod.lo != cur or pod.hi <= pod.lo:
                raise ValueError(
                    "pods must tile the fleet contiguously in index order; "
                    f"pod{pod.index} spans [{pod.lo}, {pod.hi}) at chip "
                    f"{cur}")
            cur = pod.hi
        if cur != n:
            raise ValueError(f"pods cover [0, {cur}) of {n} fleet chips")

    @property
    def n_pods(self) -> int:
        return len(self.pods)

    # ------------------------------------------------------------------
    def step(self, now: float = 0.0,
             util: Optional[np.ndarray] = None) -> FleetReport:
        # phase 1 — poll everything first
        snaps = [pod.bus.poll(now) for pod in self.pods]
        if hasattr(self.fleet, "begin_tick"):
            self.fleet.begin_tick(now)
        self.ctx.clear()
        self.ctx.util = self._assemble_util(snaps, util)
        # phase 2 — per-pod decide + apply
        reports = [self._tick_pod(pod, snap, now, util)
                   for pod, snap in zip(self.pods, snaps)]
        # phase 3 — one global settle
        readout = self._settle(snaps, now, util)
        # phase 4 — health machine, containment, budget
        events: List[str] = []
        migrated = self._update_health(snaps, now, events)
        pod_power = self._pod_power()
        budget = self._apply_budget(pod_power, now, events)
        rep = FleetReport(now=now, reports=reports, readout=readout,
                          states={p.index: p.state for p in self.pods},
                          events=events, pod_power_w=pod_power,
                          pod_budget_w=budget, migrated=migrated)
        self.events.extend(events)
        self.history.append(rep)
        return rep

    # ------------------------------------------------------------------
    def _tick_pod(self, pod: PodDomain, snap: Snapshot, now: float,
                  util) -> LoopReport:
        if pod.state in (QUARANTINED, DRAINED):
            # contained: rails frozen at safe state, work migrated away —
            # the pod neither decides nor actuates until restored
            return LoopReport(now=now, snapshot=snap, actions=[],
                              pod=pod.index)
        t0 = time.monotonic() if self.tick_deadline_s is not None else None
        pod.rails.begin_tick(now)
        u = None if util is None else np.asarray(util)[pod.lo:pod.hi]
        actions = (pod.controller.decide(snap, util=u)
                   if pod._wants_util else pod.controller.decide(snap))
        targets = ([pod.rails]
                   + ([self.elastic] if self.elastic is not None else [])
                   + list(pod.extra))
        applied: List[Action] = []
        for a in actions:
            g = _globalize(a, pod.lo)
            applied.append(g)
            for act in targets:
                act.apply(g)
        if (t0 is not None
                and time.monotonic() - t0 > self.tick_deadline_s
                and hasattr(pod.controller, "note_deadline_miss")):
            self.deadline_misses += 1
            pod.controller.note_deadline_miss()
        return LoopReport(now=now, snapshot=snap, actions=applied,
                          pod=pod.index)

    # ------------------------------------------------------------------
    def _assemble_util(self, snaps: List[Snapshot],
                       util) -> Optional[np.ndarray]:
        if util is not None:
            return np.asarray(util, np.float32)
        parts = [snap.util(pod.width)
                 for pod, snap in zip(self.pods, snaps)]
        if all(p is None for p in parts):
            return None
        full = np.concatenate(
            [np.ones(pod.width, np.float32) if p is None
             else np.asarray(p, np.float32)
             for pod, p in zip(self.pods, parts)])
        # a chip's duty cycle saturates at 1: post-quarantine survivors
        # carry 2x the work SHARE (longer queues), not 2x the
        # instantaneous power — unclamped, the settle's leakage-thermal
        # feedback diverges at share x occupancy > ~1.5
        return np.clip(full, 0.0, 1.0)

    def _settle(self, snaps: List[Snapshot], now: float, util):
        if not hasattr(self.fleet, "settle"):
            return None
        if self.n_pods == 1:
            return self.fleet.settle(snaps[0], util=util)
        # pod 0 carries the machine-room reference sensor; per-pod ambient
        # offsets enter through each pod's own controller while the shared
        # thermal field settles at the reference ambient
        u = (self.ctx.util if util is None
             else np.asarray(util, np.float32))
        return self.fleet.settle(Snapshot(now=now, t_amb=snaps[0].t_amb),
                                 util=u)

    # -- health machine -------------------------------------------------
    def _survivors(self, pod: PodDomain) -> List[PodDomain]:
        return [p for p in self.pods
                if p is not pod and p.state in (HEALTHY, DEGRADED)]

    def _update_health(self, snaps: List[Snapshot], now: float,
                       events: List[str]) -> int:
        migrated = 0
        for pod, snap in zip(self.pods, snaps):
            safe_now = sum(1 for c in self.fleet.safe_state
                           if pod.lo <= c < pod.hi)
            grew = safe_now > pod.safe_prev
            pod.safe_prev = safe_now
            if pod.state in (HEALTHY, DEGRADED):
                bad = (snap.quarantined > 0 or grew
                       or getattr(pod.controller, "watchdog_level", 0) >= 1)
                if bad:
                    pod.bad_ticks += 1
                    pod.clean_ticks = 0
                else:
                    pod.bad_ticks = 0
                    pod.clean_ticks += 1
                if (pod.state == HEALTHY
                        and pod.bad_ticks >= self.degrade_after):
                    pod.state = DEGRADED
                    events.append(f"pod{pod.index}:degraded@{now:g}")
                if (pod.state == DEGRADED
                        and pod.bad_ticks >= self.quarantine_after):
                    if self._survivors(pod):
                        migrated += self._quarantine(pod, now, events)
                    elif pod.bad_ticks == self.quarantine_after:
                        # someone has to run the fleet: the last healthy
                        # pod stays degraded under its own watchdog
                        events.append(f"pod{pod.index}:quarantine_deferred"
                                      f"(last_pod)@{now:g}")
                elif (pod.state == DEGRADED
                        and pod.clean_ticks >= self.restore_after):
                    pod.state = HEALTHY
                    events.append(f"pod{pod.index}:recovered@{now:g}")
            elif pod.state == QUARANTINED:
                pod.state = DRAINED  # containment landed last tick
                events.append(f"pod{pod.index}:drained@{now:g}")
            elif pod.state == DRAINED:
                # the host copy of the settled field: no device read
                t_slice = float(np.max(self.fleet.t_chip[pod.lo:pod.hi]))
                cool = (snap.quarantined == 0
                        and t_slice < self.restore_below_c)
                pod.cool_ticks = pod.cool_ticks + 1 if cool else 0
                if pod.cool_ticks >= self.restore_after:
                    self._restore(pod, now, events)
        return migrated

    def _quarantine(self, pod: PodDomain, now: float,
                    events: List[str]) -> int:
        pod.state = QUARANTINED
        pod.cool_ticks = 0
        events.append(f"pod{pod.index}:quarantined@{now:g}")
        # rails: drop any staged write, pin the slice to nominal safe state
        pod.rails.freeze_safe()
        # work: condemn every chip — the elastic assignment spreads the
        # pod's share over the survivors, so the very next tick's rails
        # are planned for the migrated load
        if self.elastic is not None:
            for c in range(pod.lo, pod.hi):
                self.elastic.apply(Rebalance(c, "pod_quarantine"))
        # serve: page-exact eviction through the shared HostPagePool, then
        # live-migrate the in-flight requests to the survivors' engines.
        # Greedy decode with shared weights makes the resumed outputs
        # bitwise what the home pod would have produced.
        migrated = 0
        if pod.engine is not None:
            targets = [p for p in self._survivors(pod)
                       if p.engine is not None]
            if targets:
                for req in pod.engine.drain():
                    tgt = targets[self._rr % len(targets)]
                    self._rr += 1
                    tgt.engine.submit(req)
                    migrated += 1
                if migrated:
                    events.append(
                        f"pod{pod.index}:migrated({migrated})@{now:g}")
            # no surviving engine: requests stay parked in the drained
            # pod's queue and resume on restore — never dropped
        self.migrated_total += migrated
        return migrated

    def _restore(self, pod: PodDomain, now: float,
                 events: List[str]) -> None:
        for c in range(pod.lo, pod.hi):
            self.fleet.clear_safe_state(c)
        if self.elastic is not None:
            for c in range(pod.lo, pod.hi):
                self.elastic.apply(Restore(c))
        # the pod bus's persistent safe-state set would otherwise keep
        # reporting the quarantine pins forever (the actuator only emits
        # SafeStateSample while chips are pinned): clear it so the pod's
        # controller does not re-condemn freshly restored chips
        pod.bus._state.safe_state = frozenset()
        ctl = pod.controller
        for attr, v in (("_degrade", 0), ("_clean", 0),
                        ("_degrade_since", None), ("_pending_trips", [])):
            if hasattr(ctl, attr):
                setattr(ctl, attr, v)
        pod.state = HEALTHY
        pod.bad_ticks = pod.clean_ticks = pod.cool_ticks = 0
        pod.safe_prev = 0
        events.append(f"pod{pod.index}:restored@{now:g}")

    # -- fleet power budget ---------------------------------------------
    def _pod_power(self) -> Optional[np.ndarray]:
        p = getattr(self.fleet, "p_chip", None)
        if p is None:
            return None
        p = np.asarray(p, np.float64)
        return np.asarray([float(p[pod.lo:pod.hi].sum())
                           for pod in self.pods])

    def _apply_budget(self, pod_power: Optional[np.ndarray], now: float,
                      events: List[str]) -> Optional[np.ndarray]:
        if self.power_budget_w is None:
            return None
        alive = [p for p in self.pods if p.state in (HEALTHY, DEGRADED)]
        chips_alive = sum(p.width for p in alive) or 1
        asg = getattr(self.elastic, "assignment", None)
        budget = np.zeros(self.n_pods)
        for i, pod in enumerate(self.pods):
            if pod.state in (HEALTHY, DEGRADED):
                # weight by live work share when the elastic assignment is
                # attached (a pod that absorbed a sibling's migrated load
                # gets the matching headroom); plain chip count otherwise
                budget[i] = (self.power_budget_w
                             * (asg.pod_share(pod.lo, pod.hi)
                                if asg is not None
                                else pod.width / chips_alive))
        if self.enforce_budget and pod_power is not None:
            for i, pod in enumerate(self.pods):
                eng = pod.engine
                if eng is None or pod.state not in (HEALTHY, DEGRADED):
                    continue
                if pod_power[i] > budget[i]:
                    if eng.admit_cap != 0:
                        events.append(
                            f"pod{pod.index}:over_budget"
                            f"({pod_power[i]:.0f}W>{budget[i]:.0f}W)"
                            f"@{now:g}")
                    eng.admit_cap = 0
                elif eng.admit_cap == 0:
                    eng.admit_cap = None
        return budget
