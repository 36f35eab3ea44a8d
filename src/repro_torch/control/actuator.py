"""Actuators — where controller decisions touch the (simulated) world.

The port of ``repro.control.actuator``. An :class:`Actuator` applies the
:class:`~repro_torch.control.controller.Action` dataclasses it understands
and ignores the rest:

- :class:`FleetActuator` — the rail/VID programmer of a simulated pod. It
  holds the *applied* per-chip ``(v_core, v_sram)`` on the host (plus
  straggler boost overrides that survive subsequent LUT writes), and after
  each control tick re-evaluates chip power and the steady-state thermal
  field at the applied rails (``settle``) on the substrate's device,
  producing the :class:`FleetReadout` the telemetry loop feeds back.
  The settled field stays on the device (``T``, the next settle's start);
  ``settle`` reads it back with the chip powers in ONE host transfer, and
  that host copy (``t_chip``) is what ``poll`` reports. ``host_syncs``
  counts these reads.
- :class:`EngineActuator` — admission control on the serve engine
  (:class:`Throttle` -> ``engine.admit_cap``, :class:`Preempt` ->
  ``engine.preempt_to``).

The rail-write channel takes a ``write_faults`` model
(:class:`~repro_torch.control.faults.ControlFaultModel`, whose
``nack(n, now, attempt)`` NACKs chip writes): verify-after-write with
bounded retries, then the chip pins to nominal safe-state rails.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch import to_device
from repro_torch.control.controller import (Action, BoostRail, Preempt,
                                            RailBackoff, Rebalance,
                                            SafeState, SetRails, Throttle)
from repro_torch.control.telemetry import (ChipTempSample, SafeStateSample,
                                           Sample, Snapshot)
from repro_torch.core import thermal
from repro_torch.core import tpu_fleet as TF


@runtime_checkable
class Actuator(Protocol):
    def apply(self, action: Action) -> bool:
        """Apply one action; return True when handled."""
        ...


@dataclass
class FleetReadout:
    """Power/thermal state of the pod at the applied rails."""
    pod_power_w: float
    nominal_power_w: float
    saving: float
    t_mean: float
    t_max: float


class FleetActuator:
    """Applied-rail state + thermal feedback for a ``TpuFleetSubstrate``.

    Doubles as a :class:`TelemetrySource`: ``poll`` reports the chip
    temperature field of the last ``settle`` (its host copy ``t_chip``),
    closing the loop. ``set_temps`` overwrites chips of the field, on the
    device and in the host copy (a cooling fault, a hotspot).
    """

    def __init__(self, substrate, prof: TF.StepProfile, lib: TF.TpuLibrary,
                 t_amb: float = 25.0, planner=None, field=None,
                 write_faults=None, max_retries: int = 3,
                 backoff_us: float = 50.0):
        self.substrate = substrate
        self.prof = prof
        self.lib = lib
        self.planner = planner  # shares the cached nominal-baseline solve
        self.field = field  # RailField with a baseline grid: interpolated
        # nominal reference (used before the exact planner solve when set)
        chips = substrate.n_domains
        self.v_core = np.full(chips, TF.V_CORE_NOM, np.float32)
        self.v_sram = np.full(chips, TF.V_SRAM_NOM, np.float32)
        self.boosted = set()  # chips pinned to boost rails (stragglers)
        self._boost_rails = {}  # chip -> (v_core, v_sram) boost override
        self.rebalance_log: List[Rebalance] = []
        self.backoff_log: List[RailBackoff] = []  # §V SDC rail retreats
        self.util_applied = np.ones(chips, np.float32)  # last settled util
        self.host_syncs = 0  # device -> host reads (one per settle)
        self.T = substrate.T0({"t_amb": t_amb})  # settled field, on device
        self.t_chip = self._host(self.T)  # its host copy: what poll reports
        self.p_chip = np.zeros(chips, np.float64)  # last settled chip power
        self.readout: Optional[FleetReadout] = None
        self._nominal_cache = {}
        # §9 verify-after-write rail channel: a ControlFaultModel NACKs
        # individual chip writes; bounded exponential-backoff retry, then
        # the chip pins to nominal safe-state rails until cleared
        self.write_faults = write_faults
        self.max_retries = max(int(max_retries), 0)
        self.backoff_us = float(backoff_us)
        self.safe_state: set = set()  # chips pinned at nominal rails
        self.safe_log: List[SafeState] = []
        self.write_retries = 0     # chip-writes retried after a NACK
        self.write_nacks = 0       # NACKed chip-write attempts (cumulative)
        self.backoff_wait_us = 0.0  # total modeled backoff wait
        self._now = 0.0            # control-tick clock for the fault model

    @classmethod
    def from_runtime(cls, rt, t_amb: Optional[float] = None, field=None):
        """Build over an ``EnergyAwareRuntime``'s substrate/profile/lib."""
        return cls(rt.substrate, rt.prof, rt.lib,
                   t_amb=rt.t_amb if t_amb is None else t_amb,
                   planner=rt.planner, field=field)

    def _host(self, x: torch.Tensor) -> np.ndarray:
        """One device -> host read (a host sync on the card), counted."""
        self.host_syncs += 1
        return x.cpu().numpy()

    def set_temps(self, chips, t_chip) -> None:
        """Overwrite the settled temperature of ``chips`` (an index, slice
        or index array) on the device and in the host copy ``poll``
        reports; the next ``settle`` starts from it."""
        self.T = self.T.clone()
        self.T[chips] = torch.as_tensor(t_chip, dtype=torch.float32,
                                        device=self.T.device)
        self.t_chip = self.t_chip.copy()
        self.t_chip[chips] = t_chip

    # ------------------------------------------------------------------
    def apply(self, action: Action) -> bool:
        if isinstance(action, SetRails):
            # scalar (legacy pod-uniform LUT) or per-chip (RailField /
            # solver plan) rail vectors land the same way
            vc = np.broadcast_to(np.asarray(action.v_core, np.float32),
                                 self.v_core.shape).copy()
            vs = np.broadcast_to(np.asarray(action.v_sram, np.float32),
                                 self.v_sram.shape).copy()
            for c in self.boosted:  # boosts survive field/plan rewrites
                bc, bs = self._boost_rails.get(c,
                                               (TF.V_CORE_NOM, TF.V_SRAM_NOM))
                vc[c] = bc  # each chip keeps ITS boost rails, not
                vs[c] = bs  # a pod-wide nominal pin
            self._program(vc, vs)
            return True
        if isinstance(action, SafeState):
            self._pin_safe(action.chip)
            return True
        if isinstance(action, BoostRail):
            self.boosted.add(action.chip)
            self._boost_rails[action.chip] = (action.v_core, action.v_sram)
            self.v_core[action.chip] = action.v_core
            self.v_sram[action.chip] = action.v_sram
            return True
        if isinstance(action, Rebalance):
            self.rebalance_log.append(action)
            self.boosted.discard(action.chip)
            self._boost_rails.pop(action.chip, None)
            return True
        if isinstance(action, RailBackoff):
            # the raised rails arrive in the same tick's SetRails; log the
            # event (real PMBus firmware would also latch a fault counter)
            self.backoff_log.append(action)
            return True
        return False

    def release_boost(self, chip: int) -> None:
        self.boosted.discard(chip)
        self._boost_rails.pop(chip, None)

    # -- §9 verify-after-write rail channel -----------------------------
    def begin_tick(self, now: float) -> None:
        """Clock the write channel (the fault model windows are in ticks);
        called by the loop before actions land."""
        self._now = float(now)

    def _program(self, vc: np.ndarray, vs: np.ndarray,
                 chips: Optional[np.ndarray] = None) -> None:
        """Land the target rails chip by chip.  Without a fault model this
        is one atomic write (the legacy path, bitwise identical).  With
        one, each chip write is verify-after-write: a NACKed chip retries
        with exponential backoff up to ``max_retries``, then pins to
        nominal safe-state rails until :meth:`clear_safe_state`.

        ``chips`` (global indices) addresses a *slice* of the fleet — a
        per-pod rail channel programs only its own chips; ``vc``/``vs``
        then align with ``chips``.  ``None`` keeps the full-width path."""
        if chips is None:
            n = vc.shape[0]
            for c in self.safe_state:  # pinned chips ignore new targets
                vc[c] = TF.V_CORE_NOM
                vs[c] = TF.V_SRAM_NOM
            if self.write_faults is None:
                self.v_core, self.v_sram = vc, vs
                return
            pending = np.array(
                [c for c in range(n) if c not in self.safe_state], np.int64)
            for c in self.safe_state:
                self.v_core[c] = TF.V_CORE_NOM
                self.v_sram[c] = TF.V_SRAM_NOM
            self._retry_writes(pending, vc, vs, pending.copy())
            return
        chips = np.asarray(chips, np.int64)
        vc = np.asarray(vc, np.float32).copy()
        vs = np.asarray(vs, np.float32).copy()
        safe = np.array([int(c) in self.safe_state for c in chips], bool)
        vc[safe] = TF.V_CORE_NOM
        vs[safe] = TF.V_SRAM_NOM
        if self.write_faults is None:
            self.v_core[chips] = vc
            self.v_sram[chips] = vs
            return
        self.v_core[chips[safe]] = TF.V_CORE_NOM
        self.v_sram[chips[safe]] = TF.V_SRAM_NOM
        # targets indexed per-slice: write through the global chip ids
        pend_local = np.nonzero(~safe)[0].astype(np.int64)
        full_vc = self.v_core.copy()
        full_vs = self.v_sram.copy()
        full_vc[chips] = vc
        full_vs[chips] = vs
        self._retry_writes(chips[pend_local], full_vc, full_vs,
                           chips[pend_local].copy())
        return

    def _retry_writes(self, pending: np.ndarray, vc: np.ndarray,
                      vs: np.ndarray, _orig) -> None:
        """Verify-after-write retry ladder over ``pending`` global chips,
        targets taken from full-width ``vc``/``vs``."""
        delay = self.backoff_us
        for attempt in range(self.max_retries + 1):
            nack = np.asarray(self.write_faults.nack(
                int(pending.size), self._now, attempt), bool)
            acked = pending[~nack]
            self.v_core[acked] = vc[acked]
            self.v_sram[acked] = vs[acked]
            pending = pending[nack]
            if pending.size == 0:
                return
            self.write_nacks += int(pending.size)
            if attempt < self.max_retries:
                self.write_retries += int(pending.size)
                self.backoff_wait_us += delay
                delay *= 2.0
        for c in pending:  # retries exhausted: nominal is the safe state
            self._pin_safe(int(c))

    def _pin_safe(self, chip: int) -> None:
        self.v_core[chip] = TF.V_CORE_NOM
        self.v_sram[chip] = TF.V_SRAM_NOM
        if chip not in self.safe_state:
            self.safe_state.add(chip)
            self.safe_log.append(SafeState(chip=chip, v_core=TF.V_CORE_NOM,
                                           v_sram=TF.V_SRAM_NOM))

    def clear_safe_state(self, chip: int) -> None:
        """Operator/repair path: the chip accepts writes again from the
        next SetRails on."""
        self.safe_state.discard(chip)

    # ------------------------------------------------------------------
    def settle(self, snap: Snapshot,
               util: Optional[np.ndarray] = None) -> FleetReadout:
        """Evaluate power and the steady-state thermal field at the applied
        rails under the sensed ambient (two power<->thermal sweeps from the
        previous field — the quasi-static readout between control ticks),
        on the substrate's device, with one host read of the field and the
        chip powers.

        ``util`` defaults to the snapshot's own estimate (engine load x
        elastic shares); a snapshot without either signal settles at
        ones."""
        t_amb = snap.t_amb if snap.t_amb is not None else 25.0
        chips = self.substrate.n_domains
        if util is None:
            util = snap.util(chips)
        us = np.asarray(util if util is not None else np.ones(chips),
                        np.float32)
        self.util_applied = us  # SDC telemetry reads the settled load
        m, n = self.substrate.grid
        dev = self.substrate.device
        # one upload, no host sync: the load, the applied rails and the
        # ambient (a 0-d tensor, so the thermal solve copies nothing)
        us_t, vc, vs, amb = to_device(np.stack(np.broadcast_arrays(
            us, self.v_core, self.v_sram, np.float32(t_amb))), dev)
        t_amb_dev = amb[0]
        T = self.T
        for _ in range(2):
            p = TF.chip_power(self.lib, self.prof, vc, vs, 1.0, T) * us_t
            # warm-start from the applied-rail field: between control ticks
            # the steady state drifts by well under a degree
            T = thermal.solve(p * 1e3, m, n, t_amb_dev,
                              self.substrate.thermal_cfg, T, device=dev)
        self.T = T
        self.t_chip, self.p_chip = self._host(torch.stack([T, p]))
        pod = float(self.p_chip.sum())
        p_nom = self._nominal_power(float(t_amb), us)
        self.readout = FleetReadout(
            pod_power_w=pod, nominal_power_w=p_nom,
            saving=1.0 - pod / p_nom if p_nom > 0 else 0.0,
            t_mean=float(self.t_chip.mean()), t_max=float(self.t_chip.max()))
        return self.readout

    def _nominal_power(self, t_amb: float, us: np.ndarray) -> float:
        if (self.field is not None
                and float(np.min(us)) >= self.field.u_min
                and self.field.covers_util(us)):
            # interpolated per-chip nominal baseline from the RailField's
            # solved grid — no per-tick nominal fixed point.  Only inside
            # the solved utilization axis: clamping would misreport the
            # reference (e.g. a 0.1-load tick read against the 0.25 slice
            # inflates the saving ~2.5x), so out-of-axis loads fall back
            # to the exact solve below
            p = self.field.nominal_power(t_amb, us)
            if p is not None:
                return float(np.sum(p))
        if self.planner is not None:
            # one definition of "nominal" per environment across the plane:
            # the planner's cached nominal-only fixed point (PlanOut's
            # baseline_power_w reference)
            pb = self.planner.baseline_power(self.planner.env(t_amb, us))
            return float(pb.sum())
        # standalone fallback: relaxation sweeps at nominal rails
        key = (round(t_amb, 3), us.tobytes())
        if key not in self._nominal_cache:
            m, n = self.substrate.grid
            dev = self.substrate.device
            us_t, amb = to_device(np.stack(np.broadcast_arrays(
                us, np.float32(t_amb))), dev)
            T = self.substrate.T0({"t_amb": amb[0]})
            for _ in range(3):
                p = TF.chip_power(self.lib, self.prof, TF.V_CORE_NOM,
                                  TF.V_SRAM_NOM, 1.0, T) * us_t
                T = thermal.solve(p * 1e3, m, n, amb[0],
                                  self.substrate.thermal_cfg, T, device=dev)
            self._nominal_cache[key] = float(self._host(p).sum())
            if len(self._nominal_cache) > 64:
                self._nominal_cache.pop(next(iter(self._nominal_cache)))
        return self._nominal_cache[key]

    # -- TelemetrySource -------------------------------------------------
    def poll(self, now: float) -> List[Sample]:
        out: List[Sample] = [ChipTempSample(self.t_chip)]
        if self.safe_state:  # planner sees safe-state chips via telemetry
            out.append(SafeStateSample(frozenset(self.safe_state)))
        return out


class EngineActuator:
    """Admission control on a ``serve.Engine`` (Throttle -> admit_cap,
    Preempt -> evict active low-priority slots to the host page pool)."""

    def __init__(self, engine):
        self.engine = engine
        self.log: List[Throttle] = []
        self.preempt_log: List[Preempt] = []

    def apply(self, action: Action) -> bool:
        if isinstance(action, Throttle):
            self.engine.admit_cap = action.admit_cap
            self.log.append(action)
            return True
        if isinstance(action, Preempt):
            self.engine.preempt_to(action.keep_active)
            self.preempt_log.append(action)
            return True
        return False
