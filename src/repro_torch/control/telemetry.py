"""Telemetry — what the control plane *senses*.

The port of ``repro.control.telemetry`` (host-side numpy, as the
reference's). Every producer implements the tiny :class:`TelemetrySource`
protocol: ``poll(now) -> [samples]``. Samples are plain dataclasses; the
:class:`TelemetryBus` folds whatever arrived into one :class:`Snapshot` per
control tick, which is all a controller ever sees:

- :class:`AmbientSensor` — the §III-B thermal sensor (TSD): a trace
  function ``now -> degC`` or a constant.
- :class:`EngineTelemetry` — subscribes to ``serve.Engine.on_tick`` and
  buffers :class:`TickSample`\\ s (queue depth, active slots, tick wall
  time) until the next poll.
- :class:`~repro_torch.control.actuator.FleetActuator` is also a source: it
  reports the chip-temperature field of the rails it last applied, closing
  the thermal loop.
- :class:`MonitorTelemetry` — drains ``ft.monitor.StragglerDetector``
  events (and optionally a ``Heartbeat`` dead-set) so mitigation becomes a
  controller decision instead of a dangling helper.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import (Callable, Dict, FrozenSet, List, Optional, Protocol,
                    Sequence, Union, runtime_checkable)

import numpy as np

# ---------------------------------------------------------------------------
# samples
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AmbientSample:
    """Ambient (inlet) temperature from the thermal sensor [degC].

    ``stamp`` is the poll time the reading was actually taken (None =
    fresh, i.e. taken at the delivering poll).  A stale-repeat fault
    (``control.faults``) carries the *original* stamp, which is how the
    bus's freshness check catches it."""
    t_amb: float
    stamp: Optional[float] = None


@dataclass(frozen=True)
class ChipTempSample:
    """Per-chip junction temperature field [degC] (from the actuator's
    last thermal evaluation — the simulated TSD readout), a host array.
    ``stamp`` as in :class:`AmbientSample`."""
    t_chip: np.ndarray  # (chips,)
    stamp: Optional[float] = None


@dataclass(frozen=True)
class StepSample:
    """One training/serving step wall time."""
    worker: str
    step: int
    step_s: float


@dataclass(frozen=True)
class TickSample:
    """One serve-engine scheduler tick.  ``slots`` (total cache slots) lets
    the snapshot derive a load fraction — the utilization axis of the
    RailField fast path; 0 means the producer predates the field."""
    tick: int
    queued: int
    active: int
    finished: int
    tokens: int
    tick_s: float
    slots: int = 0
    admitted: int = 0      # requests admitted this tick
    oldest_wait: float = 0.0  # ticks the oldest queued request has waited
    # actual free KV pages (paged allocator free list); -1 = producer
    # predates page telemetry, admission pricing ignores the bound
    pages_free: int = -1


@dataclass(frozen=True)
class UtilSample:
    """Per-chip work shares (1.0 = one chip's fair share; a condemned chip
    reports 0).  Produced by ``ft.elastic.ElasticActuator`` after
    ``Rebalance`` actions migrate work."""
    shares: np.ndarray  # (chips,)


@dataclass(frozen=True)
class StragglerSample:
    """A flagged straggler, mapped to the chip the controller can act on."""
    worker: str
    step: int
    ratio: float
    chip: int


@dataclass(frozen=True)
class HeartbeatSample:
    dead: FrozenSet[str]


@dataclass(frozen=True)
class SafeStateSample:
    """Chips the rail-write channel pinned to nominal safe-state rails
    (retries exhausted) — reported by the :class:`~repro_torch.control.actuator.
    FleetActuator` so the controller can rebalance work around them."""
    chips: FrozenSet[int]


@dataclass(frozen=True)
class SdcSample:
    """One tick's ABFT SDC counters (from ``tolerance.SdcTelemetry``
    or a real checksum-counter readout): detected/corrected/escaped
    injections over ``checked`` MACs of checksummed traffic."""
    detected: int
    corrected: int
    escaped: int
    checked: int


Sample = Union[AmbientSample, ChipTempSample, StepSample, TickSample,
               UtilSample, StragglerSample, HeartbeatSample, SdcSample,
               SafeStateSample]


# ---------------------------------------------------------------------------
# source protocol + snapshot
# ---------------------------------------------------------------------------


@runtime_checkable
class TelemetrySource(Protocol):
    """Anything that can be polled for samples at a control tick."""

    def poll(self, now: float) -> List[Sample]: ...


@dataclass
class Snapshot:
    """Folded telemetry state at one control tick — the controller's whole
    world view.  Scalar fields keep the latest sample; event-like fields
    (stragglers, ticks) hold everything since the previous snapshot."""

    now: float = 0.0
    t_amb: Optional[float] = None
    t_chip: Optional[np.ndarray] = None
    step_s: Optional[float] = None
    queued: int = 0
    active: int = 0
    tokens: int = 0
    tick_s: Optional[float] = None
    slots: int = 0
    admitted: int = 0           # admissions since previous snapshot
    oldest_wait: float = 0.0    # queue-head age [ticks] at latest sample
    pages_free: int = -1        # free KV pages at latest sample (-1 unknown)
    shares: Optional[np.ndarray] = None  # elastic per-chip work shares
    stragglers: List[StragglerSample] = field(default_factory=list)
    dead: FrozenSet[str] = frozenset()
    # sample freshness [ticks since the last ACCEPTED reading]: 0 on a
    # fresh tick, grows under sensor dropout/quarantine, inf before the
    # first reading — the controller's stale-fallback trigger
    t_amb_age: float = 0.0
    t_chip_age: float = 0.0
    quarantined: int = 0  # stale/range-violating samples rejected this tick
    # chips the rail-write channel pinned to nominal (SafeStateSample)
    safe_state: FrozenSet[int] = frozenset()
    # event-like ABFT SDC counters (summed over the tick's samples)
    sdc_detected: int = 0
    sdc_corrected: int = 0
    sdc_escaped: int = 0
    sdc_checked: int = 0

    # an idle pod still clocks (host traffic, refresh, collective keepalive):
    # the sensed load never folds below this floor
    LOAD_FLOOR = 0.1

    @property
    def t_max(self) -> Optional[float]:
        return None if self.t_chip is None else float(np.max(self.t_chip))

    @property
    def sdc_rate(self) -> Optional[float]:
        """Observed escaped-SDC rate per checked MAC this tick; None when
        no checksummed traffic was sensed."""
        if self.sdc_checked <= 0:
            return None
        return self.sdc_escaped / self.sdc_checked

    @property
    def load(self) -> Optional[float]:
        """Serve-engine load fraction (active slots / total), floored at
        :data:`LOAD_FLOOR`; None before any slot-aware tick arrived."""
        if self.slots <= 0:
            return None
        return max(self.active / self.slots, self.LOAD_FLOOR)

    def util(self, chips: int) -> Optional[np.ndarray]:
        """Per-chip utilization estimate for the RailField's second axis:
        elastic work shares scaled by the engine load fraction.  None when
        neither signal has been sensed (legacy ambient-only ticks)."""
        if self.shares is None and self.load is None:
            return None
        shares = (np.asarray(self.shares, np.float32)
                  if self.shares is not None
                  else np.ones(chips, np.float32))
        return (shares * (1.0 if self.load is None else self.load)
                ).astype(np.float32)


class TelemetryBus:
    """Polls every attached source and folds the samples into a Snapshot.

    Scalar state (ambient, chip temps, queue depth) persists across ticks —
    a source that has nothing new simply returns ``[]`` and the last known
    value carries forward; events (stragglers) are delivered exactly once.

    Temperature samples are **validated** before folding (the §9 fault
    containment tier): a reading older than ``max_age`` ticks (per its
    ``stamp``) or outside the plausibility range is *quarantined* — the
    last-good value carries forward and its age keeps growing, which is
    exactly the signal the controller's stale fallback keys on.  Honest
    sources stamp nothing (stamp ``None`` = fresh) and always read
    in-range, so validation is a no-op on a clean day.

    Freshness is tracked **per source** (§10 fleet tier): each accepted
    temperature reading stamps the *source* it came from, and the
    snapshot's ``t_amb_age`` / ``t_chip_age`` describe the provenance of
    the value currently folded (the last writer).  One pod's sensor going
    stale therefore cannot age out a sibling pod's last-good state when
    several pod buses share fan-out sources during a fleet tick.  With a
    single source per temperature kind this is exactly the old global
    horizon.
    """

    # plausibility ranges [degC]: anything outside is a sensor fault, not
    # a reading (chips melt long before 200C; a machine room is not -60C)
    T_AMB_VALID = (-40.0, 80.0)
    T_CHIP_VALID = (-40.0, 200.0)

    def __init__(self, sources: Sequence[TelemetrySource] = (),
                 max_age: Optional[float] = 2.0):
        self.sources: List[TelemetrySource] = list(sources)
        self.max_age = max_age
        self._state = Snapshot()
        # last ACCEPTED reading per *source* (keyed by identity), plus the
        # source whose value is currently folded — its stamp is the age
        self._amb_stamp: Dict[int, float] = {}
        self._chip_stamp: Dict[int, float] = {}
        self._amb_src: Optional[int] = None
        self._chip_src: Optional[int] = None
        self.quarantined_total = 0

    def attach(self, source: TelemetrySource) -> None:
        self.sources.append(source)

    def _valid(self, smp, now: float, rng) -> bool:
        stamp = smp.stamp
        if (self.max_age is not None and stamp is not None
                and now - stamp > self.max_age):
            return False  # stale-repeat: older than the freshness bound
        v = np.asarray(smp.t_chip if isinstance(smp, ChipTempSample)
                       else smp.t_amb, np.float64)
        return bool(np.all(np.isfinite(v))
                    and np.all(v >= rng[0]) and np.all(v <= rng[1]))

    def poll(self, now: float) -> Snapshot:
        s = self._state
        s.now = now
        s.stragglers = []
        s.tokens = 0
        s.admitted = 0
        s.quarantined = 0
        s.sdc_detected = s.sdc_corrected = 0
        s.sdc_escaped = s.sdc_checked = 0
        for src in self.sources:
            for smp in src.poll(now):
                if isinstance(smp, AmbientSample):
                    if not self._valid(smp, now, self.T_AMB_VALID):
                        s.quarantined += 1
                        continue
                    s.t_amb = float(smp.t_amb)
                    self._amb_stamp[id(src)] = now
                    self._amb_src = id(src)
                elif isinstance(smp, ChipTempSample):
                    if not self._valid(smp, now, self.T_CHIP_VALID):
                        s.quarantined += 1
                        continue
                    s.t_chip = np.asarray(smp.t_chip)
                    self._chip_stamp[id(src)] = now
                    self._chip_src = id(src)
                elif isinstance(smp, SafeStateSample):
                    s.safe_state = smp.chips
                elif isinstance(smp, StepSample):
                    s.step_s = float(smp.step_s)
                elif isinstance(smp, TickSample):
                    s.queued, s.active = smp.queued, smp.active
                    s.tokens += smp.tokens
                    s.admitted += smp.admitted
                    s.oldest_wait = smp.oldest_wait
                    s.tick_s = smp.tick_s
                    if smp.slots:
                        s.slots = smp.slots
                    if smp.pages_free >= 0:
                        s.pages_free = smp.pages_free
                elif isinstance(smp, UtilSample):
                    s.shares = np.asarray(smp.shares, np.float32)
                elif isinstance(smp, StragglerSample):
                    s.stragglers.append(smp)
                elif isinstance(smp, HeartbeatSample):
                    s.dead = smp.dead
                elif isinstance(smp, SdcSample):
                    s.sdc_detected += smp.detected
                    s.sdc_corrected += smp.corrected
                    s.sdc_escaped += smp.escaped
                    s.sdc_checked += smp.checked
        self.quarantined_total += s.quarantined
        s.t_amb_age = (float("inf") if self._amb_src is None
                       else now - self._amb_stamp[self._amb_src])
        s.t_chip_age = (float("inf") if self._chip_src is None
                        else now - self._chip_stamp[self._chip_src])
        # hand the controller a stable copy; persistent state keeps arrays
        return Snapshot(now=s.now, t_amb=s.t_amb, t_chip=s.t_chip,
                        step_s=s.step_s, queued=s.queued, active=s.active,
                        tokens=s.tokens, tick_s=s.tick_s, slots=s.slots,
                        admitted=s.admitted, oldest_wait=s.oldest_wait,
                        pages_free=s.pages_free, shares=s.shares,
                        stragglers=list(s.stragglers), dead=s.dead,
                        t_amb_age=s.t_amb_age, t_chip_age=s.t_chip_age,
                        quarantined=s.quarantined, safe_state=s.safe_state,
                        sdc_detected=s.sdc_detected,
                        sdc_corrected=s.sdc_corrected,
                        sdc_escaped=s.sdc_escaped,
                        sdc_checked=s.sdc_checked)


# ---------------------------------------------------------------------------
# concrete sources
# ---------------------------------------------------------------------------


class AmbientSensor:
    """Simulated TSD: ``trace`` is a constant or a ``now -> degC`` callable
    (diurnal sine, step change, replayed datacenter trace)."""

    def __init__(self, trace: Union[float, Callable[[float], float]]):
        self.trace = trace

    def poll(self, now: float) -> List[Sample]:
        t = self.trace(now) if callable(self.trace) else self.trace
        return [AmbientSample(float(t))]


class EngineTelemetry:
    """Buffers serve-engine tick stats; attach with
    ``engine.on_tick.append(src.on_tick)``."""

    def __init__(self) -> None:
        self._buf: List[Sample] = []

    def on_tick(self, smp: TickSample) -> None:
        self._buf.append(smp)

    def poll(self, now: float) -> List[Sample]:
        out, self._buf = self._buf, []
        return out


def _default_chip_of(worker: str) -> int:
    m = re.search(r"(\d+)$", worker)  # trailing rank: "host1-worker7" -> 7
    return int(m.group(1)) if m else 0


class MonitorTelemetry:
    """Drains ``StragglerDetector.events`` (exactly once each) and reports
    the ``Heartbeat`` dead-set; ``chip_of`` maps worker names to the chip
    index the actuator can boost.

    Pass ``topology`` (a :class:`repro_torch.launch.mesh.PodTopology`) for
    the rank -> pod-coordinate mapping with validation: non-numeric worker
    names and ranks beyond the pod map to ``-1`` (the controller counts
    them as ``unmapped`` instead of boosting a phantom chip 0). The bare
    trailing-digit parser is the default when neither ``topology`` nor
    ``chip_of`` is given.
    """

    def __init__(self, detector, heartbeat=None,
                 chip_of: Optional[Callable[[str], int]] = None,
                 topology=None):
        self.detector = detector
        self.heartbeat = heartbeat
        if chip_of is None:
            chip_of = (topology.chip_of if topology is not None
                       else _default_chip_of)
        self.chip_of = chip_of
        self._seen = len(detector.events)

    def record_step(self, worker: str, step: int, step_s: float):
        """Convenience passthrough so callers feed one object."""
        return self.detector.record(worker, step, step_s)

    def poll(self, now: float) -> List[Sample]:
        out: List[Sample] = []
        new = self.detector.events[self._seen:]
        self._seen = len(self.detector.events)
        for ev in new:
            out.append(StragglerSample(ev.worker, ev.step, ev.ratio,
                                       self.chip_of(ev.worker)))
        if self.heartbeat is not None:
            out.append(HeartbeatSample(frozenset(self.heartbeat.dead())))
        return out
