"""Live timing-fault model + stochastic SDC injector (§V).

The port of ``repro.tolerance.faults``. ``core/overscaling.error_profile``
computes a
static per-bit flip profile from an FPGA netlist's violating-path
population; this module is the same physics as a function of the live fleet
state (applied rails, chip temperature):

- :class:`TimingFaultModel` — pure queries: per-chip timing overshoot
  ``x = delay(v_core, v_sram, T + T_GUARD) / d_worst - 1``, the raw per-MAC
  SDC rate ``SDC_RATE0 * expm1(SDC_RATE_K * x)`` (exactly zero at or above
  the guard band), and the carry/MSB-concentrated per-bit flip profile the
  ABFT matmul consumes.
- :class:`FaultInjector` — seeded sampling of per-tick (injected, detected,
  corrected, escaped) counts with numpy's ``default_rng``, so the same seed
  and call order give the reference's counts exactly.
- :class:`SdcTelemetry` — the control-plane adapter: polls the injector at
  the :class:`~repro_torch.control.actuator.FleetActuator`'s *applied*
  rails and the host copy of its settled temperature field, and emits an
  :class:`~repro_torch.control.telemetry.SdcSample` per control tick.

Both are host-side models (numpy in, numpy out, as in the reference); the
delay factor is the port's float32 ``tpu_fleet.f_max_rel`` on the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.control.telemetry import SdcSample
from repro_torch.core import tpu_fleet as TF
from repro_torch.policy.policies import ABFT_ESCAPE, SDC_RATE0, SDC_RATE_K
from repro_torch.policy.substrate import T_GUARD

# carry-tail shape shared with core/overscaling.error_profile: a violation
# of depth x corrupts the top ceil(x / X_FULL * CARRY_BITS) accumulator bits
CARRY_BITS = 12
X_FULL = 0.40


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32))


@dataclass
class TimingFaultModel:
    """Per-chip timing-error physics at the live (v_core, v_sram, T)."""

    lib: TF.TpuLibrary = field(default_factory=TF.TpuLibrary)
    d_worst: float = 1.0  # the relative step-time contract

    def overshoot(self, v_core, v_sram, T) -> np.ndarray:
        """Depth of undervolt past the contract: (delay/d_worst - 1)+ at
        the guarded temperature — 0 for rails the guard band admits."""
        f = TF.f_max_rel(self.lib, _f32(v_core), _f32(v_sram),
                         _f32(T) + T_GUARD)
        d = 1.0 / f.numpy()
        return np.maximum(d / self.d_worst - 1.0, 0.0)

    def sdc_rate(self, v_core, v_sram, T, noise: float = 1.0) -> np.ndarray:
        """Raw per-MAC SDC rate at the applied rails; ``noise`` is a
        multiplicative disturbance (aging, supply noise)."""
        x = self.overshoot(v_core, v_sram, T)
        return noise * SDC_RATE0 * np.expm1(SDC_RATE_K * x)

    def escaped_rate(self, v_core, v_sram, T, noise: float = 1.0):
        """Predicted per-MAC rate that leaks past the ABFT checksums."""
        return ABFT_ESCAPE * self.sdc_rate(v_core, v_sram, T, noise)

    def bit_probs(self, v_core, v_sram, T, macs: int = 128,
                  word_bits: int = 32) -> np.ndarray:
        """Per-bit flip probability for one output element of a ``macs``-
        deep accumulation — the profile ``kernels/abft_matmul`` (and
        ``overscale_matmul``) consume. Scalar rails/temperature: one
        profile per operating point."""
        x = float(np.max(self.overshoot(v_core, v_sram, T)))
        probs = np.zeros(word_bits)
        if x <= 0.0:
            return probs
        p_elem = min(float(np.max(self.sdc_rate(v_core, v_sram, T))) * macs,
                     1.0)
        depth = min(int(np.ceil(x / X_FULL * CARRY_BITS)), CARRY_BITS)
        probs[word_bits - depth:] = p_elem / depth
        return probs


@dataclass
class SdcCounts:
    """One tick's (or one accumulated run's) SDC ledger."""
    injected: int = 0
    detected: int = 0
    corrected: int = 0
    escaped: int = 0
    checked: int = 0  # MACs covered by the checksums this tick

    def add(self, other: "SdcCounts") -> None:
        self.injected += other.injected
        self.detected += other.detected
        self.corrected += other.corrected
        self.escaped += other.escaped
        self.checked += other.checked

    @property
    def escape_rate(self) -> float:
        return self.escaped / self.checked if self.checked else 0.0


class FaultInjector:
    """Seeded per-tick SDC sampler at the applied rails.

    ``tick`` draws Poisson injections per chip at the model's raw rate over
    ``macs_per_tick`` MACs (scaled by per-chip utilization), then a
    binomial ABFT repair with coverage ``1 - ABFT_ESCAPE``. Same seed + same
    call sequence -> same counts; ``reset()`` restarts the stream.
    """

    def __init__(self, model: Optional[TimingFaultModel] = None,
                 macs_per_tick: float = 1e9, seed: int = 0,
                 noise: Optional[Callable[[float], float]] = None):
        self.model = model if model is not None else TimingFaultModel()
        self.macs_per_tick = float(macs_per_tick)
        self.seed = int(seed)
        self.noise = noise
        self.rng = np.random.default_rng(self.seed)
        self.totals = SdcCounts()

    def reset(self, seed: Optional[int] = None) -> None:
        if seed is not None:
            self.seed = int(seed)
        self.rng = np.random.default_rng(self.seed)
        self.totals = SdcCounts()

    def tick(self, now: float, v_core, v_sram, T,
             util: Optional[np.ndarray] = None) -> SdcCounts:
        noise = float(self.noise(now)) if self.noise is not None else 1.0
        rate = self.model.sdc_rate(v_core, v_sram, T, noise)  # (chips,)
        act = (np.ones_like(rate) if util is None
               else np.asarray(util, np.float64))
        lam = np.maximum(rate * act, 0.0) * self.macs_per_tick
        injected = int(np.sum(self.rng.poisson(lam)))
        detected = (int(self.rng.binomial(injected, 1.0 - ABFT_ESCAPE))
                    if injected else 0)
        counts = SdcCounts(
            injected=injected, detected=detected, corrected=detected,
            escaped=injected - detected,
            checked=int(round(float(act.sum()) * self.macs_per_tick)))
        self.totals.add(counts)
        return counts


class SdcTelemetry:
    """TelemetrySource: samples the injector at the fleet's applied state.

    Reads the :class:`~repro_torch.control.actuator.FleetActuator`'s applied
    per-chip rails, the host copy of its last settled temperature field
    (``t_chip``: no device read) and utilization — the natural one-tick
    sensor latency of a real SDC counter readout — and emits one
    ``SdcSample`` per poll.
    """

    def __init__(self, injector: FaultInjector, fleet):
        self.injector = injector
        self.fleet = fleet

    def poll(self, now: float) -> List:
        c = self.injector.tick(
            now, self.fleet.v_core, self.fleet.v_sram, self.fleet.t_chip,
            util=getattr(self.fleet, "util_applied", None))
        return [SdcSample(detected=c.detected, corrected=c.corrected,
                          escaped=c.escaped, checked=c.checked)]
