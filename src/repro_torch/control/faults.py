"""Control-plane fault injection — the chaos the loop must contain.

The port of ``repro.control.faults`` (host-side numpy, as the reference's:
the same ``numpy`` generators from the same seeds, so the port draws the
reference's faults).

"Exceeding Conservative Limits" and the reduced-voltage FPGA studies
(PAPERS.md) document how hardware run past worst-case guard bands actually
fails: thermal sensors go noisy, stuck, or silent in *bursts* (voltage- and
temperature-correlated, not i.i.d.), and rail writes NACK under the same
stress.  :class:`ControlFaultModel` is the seeded generator for exactly
those fault classes; :class:`ChaosTelemetry` applies the sensor-side ones
to any :class:`~repro_torch.control.telemetry.TelemetrySource`.

Design contract (the reference's, held by ``tests/test_torch_faults.py``):

- **deterministic** — one seed, per-concern ``numpy`` Generators (sensor
  draws and rail-write NACKs never share a stream, so wrapping an extra
  source cannot shift the write channel's draws); ``reset()`` replays the
  identical fault sequence, which is what keeps ``scenarios.chaos_day``
  fingerprint-pinned.
- **zero at rate 0** — ``ControlFaultModel(rate=0)`` is bitwise identity
  end to end: no sample is touched, no write NACKs, no watchdog events.
  Every golden pin must hold with a rate-0 model attached.
- **windowed** — faults can be confined to tick windows (the sensor storm
  and the NACK burst of ``chaos_day``); outside a window the channel is
  clean.

Fault classes
-------------
Sensor side (drawn per corruptible sample, at most one class fires):

- ``dropout`` — the sample is lost; the bus carries the last-good value
  forward and its age grows (the controller's stale fallback trigger).
- ``spike`` — value off by ``spike_c`` degC: far outside the plausibility
  range, so the bus quarantines it (validity catches it).
- ``stale`` — the previous sample is re-emitted with its *original*
  timestamp: the bus quarantines it by age (freshness catches it).
- ``stuck`` — the value freezes for ``stuck_ticks`` with fresh timestamps:
  undetectable by validity or freshness, absorbed by the controller's
  guard band / watchdog — the honest worst case.

Actuator side: ``nack(n, now, attempt)`` — per-chip rail-write NACKs for
the :class:`~repro_torch.control.actuator.FleetActuator` verify-after-write
retry channel.

Watchdog side (scripted, not drawn — a missed deadline is a property of
the host, not of a sensor): ``deadline_misses`` / ``solver_faults`` are
tick sets the controller's watchdog consumes.
"""
from __future__ import annotations

from typing import FrozenSet, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.control.telemetry import (AmbientSample, ChipTempSample,
                                           Sample)

_CLASSES = ("dropout", "spike", "stale", "stuck")


class ControlFaultModel:
    """Seeded generator for sensor, rail-write, and watchdog faults.

    Parameters
    ----------
    rate:
        Master fault probability.  Each sensor class defaults to
        ``rate / 4`` (so ~``rate`` of samples are faulted overall) and the
        rail-write NACK probability defaults to ``rate``; all are
        individually overridable.  ``rate=0`` with no overrides is the
        identity model.
    seed:
        Base seed; per-concern streams derive from it.
    dropout, spike, stale, stuck:
        Per-class sensor fault probabilities (override ``rate / 4``).
    nack:
        Per-chip, per-attempt rail-write NACK probability (override
        ``rate``).
    sensor_window, nack_window:
        Optional ``(start, end)`` tick windows (half-open) outside of which
        the respective channel is clean.
    spike_c:
        Spike magnitude [degC] — large enough that the bus plausibility
        range always rejects it.
    stuck_ticks:
        How many polls a stuck sensor keeps repeating the frozen value.
    deadline_misses, solver_faults:
        Scripted tick sets for the controller watchdog: control ticks whose
        deadline was missed / whose solver fallback diverges.
    """

    def __init__(self, rate: float = 0.0, seed: int = 0, *,
                 dropout: Optional[float] = None,
                 spike: Optional[float] = None,
                 stale: Optional[float] = None,
                 stuck: Optional[float] = None,
                 nack: Optional[float] = None,
                 sensor_window: Optional[Tuple[int, int]] = None,
                 nack_window: Optional[Tuple[int, int]] = None,
                 spike_c: float = 500.0,
                 stuck_ticks: int = 4,
                 deadline_misses: Sequence[int] = (),
                 solver_faults: Sequence[int] = ()):
        self.rate = float(rate)
        self.seed = int(seed)
        self.p = {
            "dropout": self.rate / 4 if dropout is None else float(dropout),
            "spike": self.rate / 4 if spike is None else float(spike),
            "stale": self.rate / 4 if stale is None else float(stale),
            "stuck": self.rate / 4 if stuck is None else float(stuck),
        }
        self.nack_p = self.rate if nack is None else float(nack)
        self.sensor_window = sensor_window
        self.nack_window = nack_window
        self.spike_c = float(spike_c)
        self.stuck_ticks = max(int(stuck_ticks), 1)
        self.deadline_misses: FrozenSet[int] = frozenset(
            int(t) for t in deadline_misses)
        self.solver_faults: FrozenSet[int] = frozenset(
            int(t) for t in solver_faults)
        self.reset()

    # ------------------------------------------------------------------
    def reset(self) -> None:
        """Rewind every stream: the next replay sees the identical fault
        sequence (the chaos-day determinism pin)."""
        self._r_sensor = np.random.default_rng((self.seed, 0xC1A05))
        self._r_nack = np.random.default_rng((self.seed, 0x9ACC))

    def for_pod(self, pod: int) -> "ControlFaultModel":
        """A pod-decorrelated clone for ``control.fleet``: identical fault
        classes, rates, windows and scripted ticks, but pod > 0 derives
        its streams from a seed threaded with the pod index, so sibling
        pods do not replay the same fault sequence.  ``for_pod(0)`` keeps
        the base seed — a single-pod fleet draws bitwise the same chaos
        as the flat loop."""
        seed = (self.seed if pod == 0
                else (self.seed + 0x9E3779B97F4A7C15 * int(pod)) % (1 << 63))
        return ControlFaultModel(
            rate=self.rate, seed=seed,
            dropout=self.p["dropout"], spike=self.p["spike"],
            stale=self.p["stale"], stuck=self.p["stuck"],
            nack=self.nack_p,
            sensor_window=self.sensor_window,
            nack_window=self.nack_window,
            spike_c=self.spike_c, stuck_ticks=self.stuck_ticks,
            deadline_misses=self.deadline_misses,
            solver_faults=self.solver_faults)

    @staticmethod
    def _in(window: Optional[Tuple[int, int]], now: float) -> bool:
        return window is None or window[0] <= now < window[1]

    # -- sensor channel -------------------------------------------------
    def sensor_fault(self, now: float) -> Optional[str]:
        """Draw at most one fault class for one corruptible sample (one
        uniform per call — the draw happens even outside the window so the
        stream stays aligned across window edges)."""
        u = float(self._r_sensor.random())
        if not self._in(self.sensor_window, now):
            return None
        lo = 0.0
        for cls in _CLASSES:
            hi = lo + self.p[cls]
            if lo <= u < hi:
                return cls
            lo = hi
        return None

    # -- rail-write channel ---------------------------------------------
    def nack(self, n: int, now: float, attempt: int) -> np.ndarray:
        """Per-chip NACK mask for one write attempt over ``n`` pending
        chips (True = the verify-after-write readback mismatched)."""
        if n <= 0:
            return np.zeros(0, bool)
        draw = self._r_nack.random(n)
        if self.nack_p <= 0.0 or not self._in(self.nack_window, now):
            return np.zeros(n, bool)
        return draw < self.nack_p

    # -- watchdog channel ------------------------------------------------
    def deadline_miss(self, now: float) -> bool:
        return int(now) in self.deadline_misses

    def solver_fault(self, now: float) -> bool:
        return int(now) in self.solver_faults

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"ControlFaultModel(rate={self.rate}, seed={self.seed}, "
                f"nack={self.nack_p}, windows={self.sensor_window}/"
                f"{self.nack_window})")


class ChaosTelemetry:
    """Wrap any :class:`TelemetrySource` and corrupt its temperature
    samples per the fault model.  Non-temperature samples pass through
    untouched; with ``ControlFaultModel(rate=0)`` the wrapper is bitwise
    identity (same objects, same order)."""

    def __init__(self, source, faults: ControlFaultModel):
        self.source = source
        self.faults = faults
        # per-stream (sample class) memory for stale-repeat and stuck-at
        self._last = {}   # class key -> (sample, poll time it arrived)
        self._stuck = {}  # class key -> {"sample": ..., "left": int}

    def poll(self, now: float) -> List[Sample]:
        out: List[Sample] = []
        for smp in self.source.poll(now):
            if isinstance(smp, (AmbientSample, ChipTempSample)):
                out.extend(self._corrupt(smp, now))
            else:
                out.append(smp)
        return out

    # ------------------------------------------------------------------
    @staticmethod
    def _with(smp: Sample, value, stamp) -> Sample:
        if isinstance(smp, AmbientSample):
            return AmbientSample(t_amb=value, stamp=stamp)
        return ChipTempSample(t_chip=value, stamp=stamp)

    @staticmethod
    def _value(smp: Sample):
        return smp.t_amb if isinstance(smp, AmbientSample) else smp.t_chip

    def _corrupt(self, smp: Sample, now: float) -> List[Sample]:
        key = type(smp).__name__
        stuck = self._stuck.get(key)
        if stuck is not None and stuck["left"] > 0:
            # frozen value, fresh timestamp: passes validity AND freshness
            stuck["left"] -= 1
            return [self._with(smp, self._value(stuck["sample"]), None)]
        mode = self.faults.sensor_fault(now)
        if mode == "dropout":
            return []
        if mode == "spike":
            return [self._with(smp, self._value(smp) + self.faults.spike_c,
                               None)]
        if mode == "stale":
            prev = self._last.get(key)
            if prev is not None:
                old, t_old = prev
                return [self._with(old, self._value(old), t_old)]
            # nothing to repeat yet: fall through as a clean sample
        elif mode == "stuck":
            self._stuck[key] = {"sample": smp,
                                "left": self.faults.stuck_ticks - 1}
        self._last[key] = (smp, now)
        return [smp]
