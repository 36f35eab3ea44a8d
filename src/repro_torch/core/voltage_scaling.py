"""Algorithm 1 — Thermal-Aware Voltage Selection (the paper's core flow).

The port of ``repro.core.voltage_scaling``. Fixed-point loop:
  1. d_worst = T(netlist, T_MAX, V_nom)   # STA worst case; guardbands intact
  2. given the current per-tile temperature estimate, pick the
     (V_core, V_bram) pair minimizing P_lkg + P_dyn subject to
     crit_delay(netlist, T_grid, V_core, V_bram) <= d_worst
  3. run the thermal solver on the resulting per-tile power
  4. repeat until ||dT||_inf < delta_T

A thin wrapper over :mod:`repro_torch.policy`. Static scheme: ``run`` at the
worst-case ambient + activity -> one (V_core, V_bram). Dynamic scheme:
``dynamic_lut`` builds the T_amb -> (V_core, V_bram) table as one batched
``Solver.solve_batch`` call. Every entry point takes ``device=None`` (the
CUDA card) or ``"cpu"``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import characterization as C
from repro_torch.core import thermal
from repro_torch.core.netlist import Netlist
from repro_torch.policy import PowerSave, cached_solver, fpga_substrate
from repro_torch.policy.substrate import T_GUARD, V_BRAM_GRID, V_CORE_GRID  # noqa: F401  (re-exported constants)

#: the legacy boundary search window: +-20 mV (2 grid steps) around the
#: previous solution after the first iteration
REFINE_WINDOW_V = 0.021


@dataclass
class IterRecord:
    it: int
    v_core: float
    v_bram: float
    power_mw: float
    t_junct: float
    wall_s: float


@dataclass
class VSResult:
    v_core: float
    v_bram: float
    power_mw: float
    baseline_mw: float
    saving: float
    t_junct_mean: float
    t_junct_max: float
    d_worst_ns: float
    trace: List[IterRecord] = field(default_factory=list)
    converged: bool = True


def run(netlist: Netlist, t_amb: float, act_in: float = 1.0,
        tc: thermal.ThermalConfig = thermal.ThermalConfig(),
        lib: Optional[C.DeviceLibrary] = None,
        delta_t: float = 0.1, max_iters: int = 10,
        boundary_search: bool = True, device=None) -> VSResult:
    """Algorithm 1. ``act_in``: worst-case primary-input activity.

    ``max_iters < 1`` is clamped to one iteration; the result is then marked
    unconverged unless the first thermal update already met ``delta_t``.
    """
    sub = fpga_substrate(netlist, lib, tc, device)
    solver = cached_solver(
        sub, PowerSave(), delta_t, max(int(max_iters), 1),
        refine_window=REFINE_WINDOW_V if boundary_search else None)
    t0 = time.time()
    sol = solver.solve({"t_amb": t_amb, "act": act_in})
    wall = time.time() - t0

    n_it = int(sol.n_iters)
    vcs, vbs = sub.decode(sol.idx_hist[:n_it, 0])
    trace = [IterRecord(i + 1, float(vcs[i]), float(vbs[i]),
                        float(sol.p_hist[i]), float(sol.tj_hist[i]),
                        wall / n_it)
             for i in range(n_it)]

    baseline_mw, _ = baseline_power(netlist, t_amb, act_in, tc, lib,
                                    max_iters=10, delta_t=delta_t,
                                    device=sub.device)
    power = trace[-1].power_mw
    return VSResult(
        v_core=trace[-1].v_core, v_bram=trace[-1].v_bram, power_mw=power,
        baseline_mw=baseline_mw,
        saving=1.0 - power / baseline_mw,
        t_junct_mean=float(np.mean(sol.T)),
        t_junct_max=float(np.max(sol.T)),
        d_worst_ns=sub.d_worst, trace=trace, converged=bool(sol.converged),
    )


def baseline_power(netlist: Netlist, t_amb: float, act_in: float,
                   tc: thermal.ThermalConfig, lib=None,
                   max_iters: int = 10, delta_t: float = 0.1, device=None):
    """Nominal-voltage power at its own thermal fixed point."""
    sub = fpga_substrate(netlist, lib, tc, device).nominal_only()
    solver = cached_solver(sub, PowerSave(), delta_t, max(int(max_iters), 1))
    sol = solver.solve({"t_amb": t_amb, "act": act_in})
    # legacy semantics: power re-evaluated at the converged temperatures
    return float(sol.p_final[0]), sol.T


def dynamic_lut(netlist: Netlist, t_ambs, act_in: float = 1.0,
                tc: thermal.ThermalConfig = thermal.ThermalConfig(),
                lib=None, device=None) -> Dict[float, Tuple[float, float]]:
    """The on-line scheme's lookup table: T_amb -> (V_core, V_bram), built
    as one batched fixed point over the ambients."""
    sub = fpga_substrate(netlist, lib, tc, device)
    solver = cached_solver(sub, PowerSave(), 0.1, 10,
                           refine_window=REFINE_WINDOW_V)
    t = np.asarray([float(x) for x in t_ambs], np.float32)
    sol = solver.solve_batch({"t_amb": t, "act": np.full_like(t, act_in)})
    vc, vb = sub.decode(sol.idx[:, 0])
    return {float(t[i]): (float(vc[i]), float(vb[i]))
            for i in range(len(t))}
