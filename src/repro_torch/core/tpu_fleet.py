"""TPU-fleet power/thermal model — the paper's library, re-parameterised.

The port of ``repro.core.tpu_fleet``: the "resource classes" are TPU blocks
and the "tiles" are chips of a 16x16 pod. Per-chip rails mirror the paper's
V_core / V_bram split: ``v_core`` (MXU + vector) and ``v_sram`` (VMEM + HBM
PHY) — SRAM keeps the higher rail and the steeper delay/voltage curve,
exactly the BRAM role. The constants are the reference's, unchanged; they
describe the modelled fleet, not the card the port runs on.

The step-time contract plays the d_worst role: a training/serving step is
rated at worst-case junction temperature; actual temperatures leave margin
that voltage scaling converts to power or that frequency scaling converts to
minimum energy. The functions are float32 tensor math that broadcasts over
chip arrays, as the reference's are.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.core import thermal

# resource classes
MXU, VPU, SRAM, HBMIO, ICI = range(5)
CLASS_NAMES = ["MXU", "VPU", "SRAM", "HBMIO", "ICI"]

T_MAX_CHIP = 95.0  # junction limit
V_CORE_NOM = 0.75
V_SRAM_NOM = 0.85
F_NOM_GHZ = 0.94
KELVIN = 273.15


def _t(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


@dataclass(frozen=True)
class TpuLibrary:
    """Alpha-power delay + exponential leakage per class (paper-style fits)."""
    vth0: Tuple[float, ...] = (0.42, 0.42, 0.52, 0.40, 0.40)
    alpha: Tuple[float, ...] = (0.95, 0.95, 0.80, 1.00, 1.00)
    mu_exp: Tuple[float, ...] = (1.40, 1.40, 1.10, 1.20, 1.20)
    vth_kappa: float = 0.0008
    # busy power at nominal (V, f_nom), per chip [W]
    p_busy: Tuple[float, ...] = (90.0, 20.0, 25.0, 35.0, 15.0)
    # leakage at 25C, nominal V [W]
    p_lkg0: Tuple[float, ...] = (18.0, 5.0, 12.0, 6.0, 4.0)
    lkg_T: float = 0.015
    lkg_eta: float = 7.0
    dyn_vexp: float = 2.0
    v_nom: Tuple[float, ...] = (V_CORE_NOM, V_CORE_NOM, V_SRAM_NOM,
                                V_SRAM_NOM, V_CORE_NOM)

    def _a(self, name, cls):
        return _t(getattr(self, name))[cls]

    def delay_factor(self, cls, V, T):
        """d(V,T)/d(Vnom,Tmax) for class cls (scalar or tensors)."""
        V, T = _t(V), _t(T)
        vth0 = self._a("vth0", cls)
        a = self._a("alpha", cls)
        m = self._a("mu_exp", cls)
        vn = self._a("v_nom", cls)
        vth = vth0 + self.vth_kappa * (T_MAX_CHIP - T)
        mu = torch.pow((T + KELVIN) / (T_MAX_CHIP + KELVIN), -m)
        vov = torch.clamp(V - vth, min=0.02)
        return (V / vn) * torch.pow((vn - vth0) / vov, a) / mu

    def leakage(self, cls, V, T):
        V, T = _t(V), _t(T)
        vn = self._a("v_nom", cls)
        p0 = self._a("p_lkg0", cls)
        return (p0 * torch.exp(self.lkg_T * (T - 25.0)) * (V / vn)
                * torch.exp(self.lkg_eta * (V - vn)))

    def dynamic(self, cls, V, f_rel, util):
        V = _t(V)
        vn = self._a("v_nom", cls)
        p0 = self._a("p_busy", cls)
        return p0 * _t(util) * _t(f_rel) * torch.pow(V / vn, self.dyn_vexp)


@dataclass(frozen=True)
class StepProfile:
    """Per-step utilizations, derived from the dry-run roofline terms:
    u_class = (class roofline term) / (step time)."""
    u_mxu: float
    u_vpu: float
    u_sram: float
    u_hbm: float
    u_ici: float
    step_s: float  # rated (worst-case) step time = the contract
    # fraction of the step that scales with core clock (compute-bound part)
    f_scalable: float = 0.6

    @classmethod
    def from_roofline(cls, compute_s: float, memory_s: float,
                      collective_s: float, step_s: Optional[float] = None):
        step = step_s or max(compute_s + collective_s * 0.3, memory_s,
                             collective_s)
        return cls(
            u_mxu=min(compute_s / step, 1.0),
            u_vpu=min(0.3 * compute_s / step, 1.0),
            u_sram=min(compute_s / step, 1.0),
            u_hbm=min(memory_s / step, 1.0),
            u_ici=min(collective_s / step, 1.0),
            step_s=step,
            f_scalable=min(compute_s / step, 1.0),
        )


def chip_power(lib: TpuLibrary, prof: StepProfile, v_core, v_sram, f_rel, T):
    """Total chip power [W]; broadcasts over chip arrays."""
    V = [v_core, v_core, v_sram, v_sram, v_core]
    utils = [prof.u_mxu, prof.u_vpu, prof.u_sram, prof.u_hbm, prof.u_ici]
    total = 0.0
    for c in range(5):
        fr = f_rel if c in (MXU, VPU, SRAM) else 1.0
        total = total + lib.dynamic(c, V[c], _t(fr) * utils[c], 1.0) \
            + lib.leakage(c, V[c], T)
    return total


def f_max_rel(lib: TpuLibrary, v_core, v_sram, T):
    """Max relative clock so every class meets its pipeline timing."""
    d = torch.stack(torch.broadcast_tensors(
        lib.delay_factor(MXU, v_core, T),
        lib.delay_factor(VPU, v_core, T),
        lib.delay_factor(SRAM, v_sram, T)))
    return 1.0 / d.amax(0)


def step_time(prof: StepProfile, f_rel):
    """Step time when the core clock runs at f_rel x nominal."""
    scal = prof.f_scalable
    return prof.step_s * (scal / _t(f_rel) + (1.0 - scal))


def pod_thermal_config(theta_chip: float = 0.25, n_chips: int = 256):
    return thermal.ThermalConfig(theta_ja=theta_chip / n_chips, spreading=2.0,
                                 tol=1e-4, max_iters=20_000)
