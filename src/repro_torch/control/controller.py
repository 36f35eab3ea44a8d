"""Controllers — the decision layer between telemetry and actuation.

The port of ``repro.control.controller``. A :class:`Controller` maps one
telemetry :class:`~repro_torch.control.telemetry.Snapshot` to a list of
:class:`Action` commands. Actions are plain dataclasses; every actuator
applies the ones it understands and ignores the rest, so one decision can
fan out to the fleet (rails) and the serve engine (admission) at once.

:class:`LutController` is the paper's §III-B online scheme on the per-chip
two-axis fast path:

- **fast path** — the sensed ``(t_amb, util)`` pair is answered from the
  bilinear per-chip :class:`~repro_torch.control.lut.RailField` (host
  numpy, no solver); with an explicit scalar
  :class:`~repro_torch.control.lut.DynamicLut` the pod-median ambient-only
  path is used instead.
- **slow path** — a full fixed point through
  :class:`~repro_torch.control.planner.FleetPlanner` (the port's Solver, on
  the substrate's device) when the fast path can no longer be trusted: an
  ambient *jump* beyond ``guard_band_c`` between ticks, a sensed ambient
  outside the solved sweep, utilization beyond the solved utilization axis
  (+ ``util_band``; scalar-LUT mode keeps the ``util_drift`` trigger
  instead), or chip temperature within ``t_headroom_c`` of the rated
  junction limit.
- **straggler policy** — flagged stragglers route through
  ``FleetPlanner.mitigate``: rail-boost while nominal rails can still hold
  the clock at the chip's temperature, rebalance otherwise.
- **admission throttle** — when junction temperature crowds the limit the
  serve engine's admission is capped; the cap lifts once temperature
  drops out of the emergency band.

The §9 hooks: ``faults`` takes a
:class:`~repro_torch.control.faults.ControlFaultModel` (scripted deadline
misses and solver faults) and the watchdog ladder degrades and recovers as
in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol, Union, runtime_checkable

import numpy as np

from repro_torch.control.lut import (DEFAULT_UTIL_KNOTS, DynamicLut,
                                     RailField, sweep_points)
from repro_torch.control.planner import FleetPlanner, PlanOut
from repro_torch.control.telemetry import Snapshot
from repro_torch.core import tpu_fleet as TF

# ---------------------------------------------------------------------------
# actions
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SetRails:
    """Program (v_core, v_sram) — scalars (uniform pod) from the LUT fast
    path, or per-chip arrays from a full solver replan."""
    v_core: Union[float, np.ndarray]
    v_sram: Union[float, np.ndarray]
    source: str  # "lut" | "solver"
    plan: Optional[PlanOut] = None  # attached on solver replans


@dataclass(frozen=True)
class BoostRail:
    """Straggler mitigation: pin one chip back to nominal rails."""
    chip: int
    v_core: float
    v_sram: float
    extra_power_w: float


@dataclass(frozen=True)
class Rebalance:
    """Rails alone cannot hold the clock — shed/move work off this chip."""
    chip: int
    reason: str


@dataclass(frozen=True)
class Throttle:
    """Cap serve-engine admissions per tick (None lifts the throttle)."""
    admit_cap: Optional[int]


@dataclass(frozen=True)
class RailBackoff:
    """§V closed loop: the observed escaped-SDC rate exceeded the accuracy
    budget — retreat the below-guard-band rails one 10 mV step (``steps``
    is the cumulative retreat depth).  The adjusted rails ride in the same
    tick's :class:`SetRails`; this action is the observable event the
    actuators log."""
    steps: int
    rate: float
    budget: float


@dataclass(frozen=True)
class Restore:
    """Re-admit a cooled condemned chip: its work share migrates back
    (the ``ElasticWorkAssignment.restore`` actuation)."""
    chip: int


@dataclass(frozen=True)
class SafeState:
    """Pin one chip to nominal safe-state rails.  Originates in the
    :class:`~repro_torch.control.actuator.FleetActuator` write channel when a
    rail write exhausts its retries (observable in ``safe_log``, like
    ``RailBackoff``); applying it by hand force-pins a chip."""
    chip: int
    v_core: float
    v_sram: float
    reason: str = "write_nack"


@dataclass(frozen=True)
class Preempt:
    """Thermal emergency outranks running work: evict active low-priority
    requests until at most ``keep_active`` slots stay busy.  The engine
    moves their KV pages to the host page pool and re-queues them for
    bitwise-identical resumption once the emergency clears."""
    keep_active: int
    reason: str = "thermal_emergency"


Action = Union[SetRails, BoostRail, Rebalance, Throttle, RailBackoff,
               Restore, SafeState, Preempt]


@runtime_checkable
class Controller(Protocol):
    def decide(self, snap: Snapshot) -> List[Action]: ...


# ---------------------------------------------------------------------------
# the §III-B online controller
# ---------------------------------------------------------------------------


@dataclass
class ControllerStats:
    lut_hits: int = 0
    replans: int = 0
    boosts: int = 0
    rebalances: int = 0
    throttles: int = 0
    unmapped: int = 0  # straggler events whose worker maps to no chip
    backoffs: int = 0  # SDC-budget rail retreats (error-tolerant tier)
    restores: int = 0  # cooled condemned chips re-admitted
    replan_reasons: List[str] = field(default_factory=list)
    # §9 fault containment
    quarantined: int = 0       # bus-rejected samples seen (cumulative)
    stale_fallbacks: int = 0   # ticks answered at last-good + guard band
    degraded_ticks: int = 0    # ticks run at watchdog level >= 1
    frozen_ticks: int = 0      # ticks run at watchdog level 2 (frozen)
    safe_states: int = 0       # chips seen entering rail safe state
    below_axis_clamps: int = 0  # fast-path lookups clamped below u_min
    watchdog_events: List[str] = field(default_factory=list)
    recover_ticks: List[float] = field(default_factory=list)  # per episode


class LutController:
    """Batched-table fast path with a guard-banded full-solver fallback.

    The default fast path is a per-chip 2-axis :class:`RailField` (built by
    one early-freeze ``solve_batch`` over the ``sweep x util_sweep`` grid).
    Passing an explicit scalar ``lut=DynamicLut(...)`` selects the legacy
    pod-median ambient-only behavior (the pre-RailField controller, kept
    as a facade and as a comparison baseline).
    """

    DEFAULT_SWEEP = (10.0, 45.0, 8)  # (lo degC, hi degC, knots)

    def __init__(self, planner: FleetPlanner,
                 lut: Optional[DynamicLut] = None,
                 field: Optional[RailField] = None,
                 sweep=None,
                 util_sweep=None,
                 guard_band_c: float = 2.0,
                 util_band: float = 0.25,
                 t_headroom_c: float = 5.0,
                 throttle_cap: int = 1,
                 sdc_budget: Optional[float] = None,
                 sdc_hysteresis: int = 3,
                 backoff_step_v: float = 0.010,
                 restore_after: Optional[int] = None,
                 restore_below_c: float = 70.0,
                 faults=None,
                 stale_after: Optional[float] = 2.0,
                 watchdog_hysteresis: int = 3):
        self.planner = planner
        if field is None and lut is None:
            lo, hi, n = sweep if sweep is not None else self.DEFAULT_SWEEP
            u_knots = (sweep_points(*util_sweep)
                       if util_sweep is not None else DEFAULT_UTIL_KNOTS)
            # ONE early-freeze solve_batch covers the whole 2-D sweep grid
            field = planner.rail_field(sweep_points(lo, hi, n), u_knots)
        self.field = field
        # the scalar facade: explicit legacy mode, or the field's pod-median
        # reduction (kept for introspection / repr / legacy callers)
        self.lut = lut if lut is not None else field.median_lut()
        self.guard_band_c = guard_band_c
        self.util_band = util_band
        self.t_headroom_c = t_headroom_c
        self.throttle_cap = throttle_cap
        # error-tolerant tier (§V): back one rail step off when the sensed
        # escaped-SDC rate exceeds the budget, re-descend one step per
        # clean hysteresis window.  None disables (legacy behavior).
        self.sdc_budget = sdc_budget
        self.sdc_hysteresis = max(int(sdc_hysteresis), 1)
        self.backoff_step_v = backoff_step_v
        # hysteresis-based restore of cooled condemned chips; None disables
        self.restore_after = restore_after
        self.restore_below_c = restore_below_c
        # §9 fault containment: chaos scripting (scripted deadline-miss /
        # solver-fault ticks), stale-sensor fallback bound, and the
        # watchdog's clean-tick de-escalation window
        self.faults = faults
        self.stale_after = stale_after
        self.watchdog_hysteresis = max(int(watchdog_hysteresis), 1)
        self.stats = ControllerStats()
        self.plan: Optional[PlanOut] = None  # last full-solver plan
        self._t_prev: Optional[float] = None
        self._util_planned: Optional[np.ndarray] = None
        self._T_warm = None  # warm start for replans
        self._throttled = False
        self._backoff = 0          # cumulative SDC rail-retreat steps
        self._sdc_clean = 0        # consecutive within-budget ticks
        self._cool: Dict[int, int] = {}  # condemned chip -> cool ticks
        # watchdog ladder: 0 = normal, 1 = fast path only, 2 = frozen
        self._degrade = 0
        self._clean = 0            # consecutive event-free ticks
        self._degrade_since: Optional[float] = None
        self._last_rails = None    # (vc, vs) as last programmed
        self._pending_trips: List[str] = []  # loop-reported deadline misses
        self._safe_seen: set = set()  # safe-state chips already rebalanced

    # ------------------------------------------------------------------
    def reset(self) -> None:
        """Forget the online state (the field/luts and compiled solvers
        stay warm): the next tick is a cold start.  Scenario replays call
        this so a reused controller starts every replayed day from the
        same state — stats are NOT cleared (they are cumulative; replays
        report deltas)."""
        self.plan = None
        self._t_prev = None
        self._util_planned = None
        self._T_warm = None
        self._throttled = False
        self._backoff = 0
        self._sdc_clean = 0
        self._cool = {}
        self._degrade = 0
        self._clean = 0
        self._degrade_since = None
        self._last_rails = None
        self._pending_trips = []
        self._safe_seen = set()
        if self.faults is not None:
            self.faults.reset()
        self.planner.T_last = None  # first replan restarts deterministic

    # ------------------------------------------------------------------
    @property
    def watchdog_level(self) -> int:
        """Current watchdog ladder rung: 0 normal, 1 fast-path only,
        2 frozen rails.  The fleet health state machine (``control.fleet``)
        aggregates this per pod."""
        return self._degrade

    # ------------------------------------------------------------------
    def _replan_reason(self, snap: Snapshot,
                       util: Optional[np.ndarray]) -> Optional[str]:
        t = snap.t_amb
        if self._t_prev is None:
            return "cold_start"
        if abs(t - self._t_prev) > self.guard_band_c:
            return f"ambient_jump({t - self._t_prev:+.1f}C)"
        table = self.field if self.field is not None else self.lut
        if not table.covers(t, margin=self.guard_band_c):
            return f"lut_range({t:.1f}C)"
        if util is not None:
            if self.field is not None:
                # load swings ride the utilization axis; only an excursion
                # PAST the solved axis (where the clamp would under-volt
                # nothing and under-protect everything) forces the solver
                if not self.field.covers_util(util, margin=self.util_band):
                    return f"util_range({float(np.max(util)):.2f})"
            else:
                ref = (self._util_planned if self._util_planned is not None
                       else np.ones_like(util))
                if float(np.max(np.abs(util - ref))) > self.util_band:
                    return "util_drift"
        if (snap.t_max is not None
                and snap.t_max > TF.T_MAX_CHIP - self.t_headroom_c):
            return f"thermal_emergency({snap.t_max:.1f}C)"
        return None

    # -- §9 watchdog ----------------------------------------------------
    def note_deadline_miss(self) -> None:
        """Report a missed tick deadline (called by the loop, between
        ticks): the next decision degrades one watchdog level."""
        self._pending_trips.append("deadline_miss")

    def _trip(self, event: str, now: float) -> None:
        if self._degrade == 0:
            self._degrade_since = now
        self._degrade = min(self._degrade + 1, 2)
        self._clean = 0
        self.stats.watchdog_events.append(f"{event}@{now:g}")

    def _fast_rails(self, t_amb: float, util):
        """The interpolated fast path, with the below-axis clamp counted
        (a silent clamp would hide sub-``u_min`` load excursions)."""
        if self.field is not None:
            if (util is not None and np.size(util)
                    and float(np.min(np.asarray(util)))
                    < self.field.u_min - 1e-9):
                self.stats.below_axis_clamps += 1
            return self.field.lookup(t_amb, util)
        return self.lut.lookup(t_amb)

    def _plan_ok(self, plan: PlanOut) -> bool:
        """Reject a diverged solver fallback: non-finite or out-of-band
        rails / junction temperature (bounds loose enough that every
        healthy fixed point passes untouched)."""
        vc = np.asarray(plan.v_core, np.float64)
        vs = np.asarray(plan.v_sram, np.float64)
        return bool(np.all(np.isfinite(vc)) and np.all(np.isfinite(vs))
                    and np.all(vc > 0.2) and np.all(vs > 0.2)
                    and np.all(vc <= TF.V_CORE_NOM + 0.1)
                    and np.all(vs <= TF.V_SRAM_NOM + 0.1)
                    and np.isfinite(plan.t_max)
                    and plan.t_max <= TF.T_MAX_CHIP + 40.0)

    def decide(self, snap: Snapshot,
               util: Optional[np.ndarray] = None) -> List[Action]:
        if snap.t_amb is None:
            return []  # nothing sensed yet
        if util is None:
            # serve-engine load x elastic work shares, when telemetry
            # carries them (None otherwise: the legacy ambient-only tick)
            util = snap.util(self.planner.substrate.n_domains)
        actions: List[Action] = []
        self.stats.quarantined += snap.quarantined
        # watchdog events first: this tick's rails already reflect them
        tripped = False
        for ev in self._pending_trips:
            self._trip(ev, snap.now)
            tripped = True
        self._pending_trips = []
        if self.faults is not None and self.faults.deadline_miss(snap.now):
            self._trip("deadline_miss", snap.now)
            tripped = True
        # §V error-tolerant tier: fold the observed escaped-SDC rate into
        # the cumulative back-off depth BEFORE programming rails, so this
        # tick's SetRails already carries the retreat.  One 10 mV step per
        # over-budget tick; one step back down per clean hysteresis window.
        if self.sdc_budget is not None and snap.sdc_checked > 0:
            rate = snap.sdc_escaped / snap.sdc_checked
            if rate > self.sdc_budget:
                self._backoff = min(self._backoff + 1, 20)
                self._sdc_clean = 0
                self.stats.backoffs += 1
                actions.append(RailBackoff(steps=self._backoff, rate=rate,
                                           budget=self.sdc_budget))
            elif self._backoff > 0:
                self._sdc_clean += 1
                if self._sdc_clean >= self.sdc_hysteresis:
                    self._backoff -= 1
                    self._sdc_clean = 0
        # stale-sensor fallback: the bus quarantined / lost the fresh
        # ambient reading, so answer at last-good PLUS the guard band
        # (conservatively hot => conservatively high rails) and never hand
        # a stale value to the solver.
        stale = (self.stale_after is not None
                 and snap.t_amb_age > self.stale_after)
        t_sense = snap.t_amb + (self.guard_band_c if stale else 0.0)
        if stale:
            self.stats.stale_fallbacks += 1
        reason = None
        if self._degrade == 0:
            if not stale:
                reason = self._replan_reason(snap, util)
            elif (snap.t_max is not None
                    and snap.t_max > TF.T_MAX_CHIP - self.t_headroom_c):
                # chip-side thermal emergency outranks sensor staleness
                reason = f"thermal_emergency({snap.t_max:.1f}C)"
        if self._degrade >= 2 and self._last_rails is not None:
            # watchdog level 2: freeze at the last programmed rails (which
            # already carry any SDC back-off — do NOT re-add dv below)
            vc, vs = self._last_rails
            self.stats.frozen_ticks += 1
            self.stats.degraded_ticks += 1
            source, plan_out = "frozen", None
        elif reason is not None:
            faulted = (self.faults is not None
                       and self.faults.solver_fault(snap.now))
            plan = None
            if not faulted:
                plan, T = self.planner.plan_at(snap.t_amb, util,
                                               T0=self._T_warm)
                if not self._plan_ok(plan):
                    faulted = True
            if faulted:
                # solver divergence: trip the watchdog and answer this
                # tick from the fast path instead of programming garbage
                self._trip("solver_divergence", snap.now)
                tripped = True
                vc, vs = self._fast_rails(t_sense, util)
                self.stats.lut_hits += 1
                source, plan_out = "lut", None
            else:
                self._T_warm = T
                self._util_planned = (None if util is None
                                      else np.asarray(util, np.float32))
                self.plan = plan
                self.stats.replans += 1
                self.stats.replan_reasons.append(reason)
                vc, vs = plan.v_core, plan.v_sram
                source, plan_out = "solver", plan
        else:
            vc, vs = self._fast_rails(t_sense, util)
            if self._degrade == 1:
                self.stats.degraded_ticks += 1
            self.stats.lut_hits += 1
            source, plan_out = "lut", None
        if self._backoff > 0 and source != "frozen":
            dv = np.float32(self._backoff * self.backoff_step_v)
            vc = np.minimum(np.asarray(vc, np.float32) + dv,
                            np.float32(TF.V_CORE_NOM))
            vs = np.minimum(np.asarray(vs, np.float32) + dv,
                            np.float32(TF.V_SRAM_NOM))
        actions.append(SetRails(vc, vs, source=source, plan=plan_out))
        self._last_rails = (vc, vs)
        self._t_prev = snap.t_amb

        # straggler policy: boost while nominal rails can hold the clock
        chips = self.planner.substrate.n_domains
        for s in snap.stragglers:
            if not 0 <= s.chip < chips:  # unmappable worker name: no chip
                self.stats.unmapped += 1  # to boost — surface, don't crash
                continue
            if (snap.shares is not None and s.chip < len(snap.shares)
                    and snap.shares[s.chip] <= 0.0):
                continue  # work already migrated off (condemned): a boost
                # would burn power on a draining chip
            T_chip = (float(snap.t_chip[s.chip]) if snap.t_chip is not None
                      else (self.plan.t_max if self.plan else 60.0))
            ref = self.plan or _nominal_plan(self.planner)
            d = self.planner.mitigate(ref, s.chip, T_chip)
            if d["action"] == "boost_rail":
                self.stats.boosts += 1
                actions.append(BoostRail(d["chip"], d["v_core"],
                                         d["v_sram"], d["extra_power_w"]))
            else:
                self.stats.rebalances += 1
                actions.append(Rebalance(d["chip"], d["reason"]))

        # admission throttle on thermal pressure (hysteresis: lift 2C lower)
        if snap.t_max is not None:
            hot = snap.t_max > TF.T_MAX_CHIP - self.t_headroom_c
            cool = snap.t_max < TF.T_MAX_CHIP - self.t_headroom_c - 2.0
            if hot and not self._throttled:
                self._throttled = True
                self.stats.throttles += 1
                actions.append(Throttle(self.throttle_cap))
            elif cool and self._throttled:
                self._throttled = False
                actions.append(Throttle(None))

        # re-admit a condemned chip (share 0) once its junction stays under
        # restore_below_c for restore_after consecutive ticks (cool-down
        # hysteresis: one hot tick resets the counter).  Off by default —
        # legacy replays keep the condemned chip condemned.
        if (self.restore_after is not None and snap.shares is not None
                and snap.t_chip is not None):
            n = min(len(snap.shares), len(snap.t_chip))
            for chip in range(n):
                if snap.shares[chip] > 0.0:
                    self._cool.pop(chip, None)
                    continue
                if float(snap.t_chip[chip]) >= self.restore_below_c:
                    self._cool.pop(chip, None)
                    continue
                ticks = self._cool.get(chip, 0) + 1
                if ticks >= self.restore_after:
                    self._cool.pop(chip, None)
                    self.stats.restores += 1
                    actions.append(Restore(chip))
                else:
                    self._cool[chip] = ticks

        # chips pinned to safe-state rails (rail-write NACK exhaustion):
        # migrate their work once each so the planner rebalances around
        # the nominal-rail island instead of budgeting scaled power for it
        for chip in sorted(snap.safe_state):
            if chip not in self._safe_seen:
                self._safe_seen.add(chip)
                self.stats.safe_states += 1
                self.stats.rebalances += 1
                actions.append(Rebalance(chip, "safe_state_rails"))

        # watchdog hysteresis: one clean-tick window per de-escalation
        # step (mirror of sdc_hysteresis), full recovery closes the
        # episode and records its tick count
        if tripped:
            self._clean = 0
        elif self._degrade > 0:
            self._clean += 1
            if self._clean >= self.watchdog_hysteresis:
                self._degrade -= 1
                self._clean = 0
                if self._degrade == 0 and self._degrade_since is not None:
                    self.stats.recover_ticks.append(
                        float(snap.now - self._degrade_since))
                    self._degrade_since = None
        return actions


def _nominal_plan(planner: FleetPlanner) -> PlanOut:
    """Fallback mitigation reference before any replan has run: nominal
    rails, per-chip nominal busy power (only ``power_w[chip]`` is read)."""
    chips = planner.substrate.n_domains
    p_nom = float(TF.chip_power(planner.lib, planner.prof, TF.V_CORE_NOM,
                                TF.V_SRAM_NOM, 1.0, 60.0))
    return PlanOut(
        v_core=np.full(chips, TF.V_CORE_NOM, np.float32),
        v_sram=np.full(chips, TF.V_SRAM_NOM, np.float32),
        f_rel=np.ones(chips, np.float32),
        power_w=np.full(chips, p_nom, np.float32),
        step_s=planner.prof.step_s, pod_power_w=p_nom * chips,
        baseline_power_w=p_nom * chips, saving=0.0,
        t_mean=60.0, t_max=60.0)
