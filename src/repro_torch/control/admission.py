"""Thermal-aware admission control — co-scheduling admissions with rails.

The port of ``repro.control.admission`` (host-side numpy: the pricing
reads the field's ``p_nom`` grid, no device work). The serve engine admits
queued requests whenever a cache slot is free; the rail plan prices the
*power* of the utilization those admissions create. This module closes the
loop between the two (DESIGN.md §8): admission is
itself a thermal actuation, so the admission budget and the rail plan are
decided **jointly**, every control tick, from one snapshot.

Why instantaneous tokens/joule is the wrong objective: pod power has a
large load-independent intercept (leakage, clocks, fabric keepalive), so
the *instantaneous* tokens/joule always improves with more admissions —
a myopic optimizer degenerates to "admit everything", which is exactly the
throughput-only baseline.  The gain the paper's thermal margin buys is
**intertemporal**: a token served at a cool ambient runs on lower rails
(V² power) than the same token at a hot ambient.  When traffic has slack,
deferring marginal admissions from hot ticks to cool ticks serves the same
tokens for fewer joules.

:class:`AdmissionController` prices that arbitrage from the
:class:`~repro_torch.control.lut.RailField`'s per-chip nominal-power grid
(``p_nom``, solved on the same ``ambient x utilization`` knots as the
rails — no extra fixed points at decision time):

- the **marginal power** of the k-th admission at ambient ``t`` is
  ``P(t, u_k) - P(t, u_{k-1})`` with ``u_k = (active + k) / slots``;
- the **reference price** is the same marginal taken at the *cheapest*
  ambient knot the field knows — the best the day will offer;
- the k-th admission is taken while its price is within
  ``defer_premium`` of the reference; past that it is deferred to a
  cooler tick.

Deferral is starvation-bounded by **SLO forcing**: once the queue head has
waited ``max_wait`` engine ticks, the full backlog is admitted regardless
of price — on a day that never cools, every request still runs within its
deadline.  An optional ``min_active`` floor additionally keeps that many
slots busy whenever the queue is non-empty (trading arbitrage for
latency); it defaults to 0 because trickling work through the expensive
window erodes exactly the hot->cool shift the pricing buys.

The chosen budget ``k*`` is emitted as a :class:`~repro_torch.control.controller.
Throttle` (the knob :class:`~repro_torch.control.actuator.EngineActuator`
programs into ``Engine.admit_cap``), and the wrapped
:class:`~repro_torch.control.controller.LutController` is asked for rails at the
**planned** utilization ``u_{k*}`` — the load the pod is about to run, not
the load it sensed — so ``SetRails`` and ``Throttle`` land as one decision.
The inner controller's thermal-emergency throttle remains authoritative:
its cap, when armed, floors ours.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from repro_torch.control.controller import (Action, LutController, Preempt,
                                            Throttle)
from repro_torch.control.telemetry import Snapshot

_EPS = 1e-9


@dataclass
class AdmissionStats:
    priced: int = 0        # control ticks that ran the pricing loop
    granted: int = 0       # cumulative admission budget granted
    deferred: int = 0      # admissions priced out to a cooler tick
    forced: int = 0        # SLO-forced full-backlog admissions
    passthrough: int = 0   # ticks with no pricing signal (no field/p_nom)
    preempts: int = 0      # thermal-emergency Preempt actions emitted


class AdmissionController:
    """Joint admission + rail decisions over a wrapped :class:`LutController`.

    Parameters
    ----------
    inner:
        The rail controller to wrap.  Its ``field.p_nom`` grid is the
        pricing signal; without one (legacy scalar-LUT mode) admission
        degrades gracefully to the throughput-only behavior (no cap).
    defer_premium:
        Admit the k-th request while its marginal power is within this
        factor of the same marginal at the field's cheapest ambient knot.
        ``1.0`` defers anything pricier than the day's best; large values
        never defer (throughput-only).
    max_wait:
        Queue-head age [engine ticks] past which the backlog is admitted
        regardless of price — the SLO guard.
    min_active:
        Keep at least this many slots busy while the queue is non-empty,
        price notwithstanding (0 = pure price + SLO).
    """

    def __init__(self, inner: LutController, defer_premium: float = 1.15,
                 max_wait: float = 64.0, min_active: int = 0,
                 preempt: bool = False):
        self.inner = inner
        self.defer_premium = float(defer_premium)
        self.max_wait = float(max_wait)
        self.min_active = int(min_active)
        # opt-in §9 escalation: while the inner thermal-emergency throttle
        # is armed AND more slots are active than it allows, emit a Preempt
        # evicting the excess low-priority work (admission caps only stop
        # NEW work; a runaway needs active load shed too)
        self.preempt = bool(preempt)
        self.stats = AdmissionStats()
        self._thermal_cap: Optional[int] = None  # inner emergency throttle

    # ------------------------------------------------------------------
    @property
    def field(self):
        return self.inner.field

    def reset(self) -> None:
        """Scenario-replay cold start (stats stay cumulative, like inner)."""
        self.inner.reset()
        self._thermal_cap = None

    # ------------------------------------------------------------------
    def _pod_power(self, t_amb: float, load: float) -> float:
        """Pod nominal power at a load fraction.  Below the field's solved
        utilization axis the table clamps — which would price the first
        admissions of an idle pod at zero — so extend linearly to the
        origin instead (chip power is ~proportional to utilization)."""
        f = self.field
        if load < f.u_min:
            return float(np.sum(f.nominal_power(t_amb, f.u_min))) \
                * (load / f.u_min)
        return float(np.sum(f.nominal_power(t_amb, load)))

    def _budget(self, snap: Snapshot) -> int:
        """Admission budget k*: price each marginal admission against the
        cheapest ambient the field knows; SLO pressure admits everything.

        The slot bound is additionally clipped to the engine's *actual*
        free KV pages (``pages_free``; -1 = page telemetry absent): with
        the paged allocator any free page serves any slot, so the page
        count IS the admission capacity — no fragmentation haircut."""
        slots = snap.slots
        want = min(snap.queued, max(slots - snap.active, 0))
        if snap.pages_free >= 0:
            want = min(want, snap.pages_free)
        if want <= 0:
            return 0
        if snap.oldest_wait >= self.max_wait:
            self.stats.forced += 1
            return want  # SLO guard: the deadline outranks the price
        k = 0
        for i in range(1, want + 1):
            u_prev = (snap.active + i - 1) / slots
            u_next = (snap.active + i) / slots
            m_now = (self._pod_power(snap.t_amb, u_next)
                     - self._pod_power(snap.t_amb, u_prev))
            m_best = min(self._pod_power(float(t), u_next)
                         - self._pod_power(float(t), u_prev)
                         for t in self.field.t)
            if m_best <= _EPS or m_now <= self.defer_premium * m_best + _EPS:
                k = i  # within premium of the day's best price: admit
            else:
                break  # pricier marginals only get worse — defer the rest
        if snap.active + k < self.min_active:
            k = min(want, self.min_active - snap.active)
        self.stats.deferred += want - k
        return k

    # ------------------------------------------------------------------
    def decide(self, snap: Snapshot,
               util: Optional[np.ndarray] = None) -> List[Action]:
        if snap.t_amb is None:
            return self.inner.decide(snap, util=util)
        priced = (snap.slots > 0 and self.field is not None
                  and self.field.p_nom is not None)
        if not priced:
            # no pricing signal: rail decisions pass through unchanged and
            # admission stays uncapped (the throughput-only behavior)
            self.stats.passthrough += 1
            return self.inner.decide(snap, util=util)
        self.stats.priced += 1
        k = self._budget(snap)
        self.stats.granted += k
        # rails are computed at the PLANNED utilization — the load the pod
        # runs once the k admissions land, not the load it sensed
        load = max((snap.active + k) / snap.slots, Snapshot.LOAD_FLOOR)
        shares = (np.asarray(snap.shares, np.float32)
                  if snap.shares is not None
                  else np.ones(self.field.chips, np.float32))
        actions = self.inner.decide(snap, util=shares * np.float32(load))
        # the inner thermal-emergency throttle (transition-emitted) floors
        # our per-tick budget for as long as it stays armed
        kept: List[Action] = []
        for a in actions:
            if isinstance(a, Throttle):
                self._thermal_cap = a.admit_cap
            else:
                kept.append(a)
        cap = k if self._thermal_cap is None else min(k, self._thermal_cap)
        kept.append(Throttle(cap))
        if (self.preempt and self._thermal_cap is not None
                and snap.active > self._thermal_cap):
            self.stats.preempts += 1
            kept.append(Preempt(keep_active=self._thermal_cap))
        return kept
