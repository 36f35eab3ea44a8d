"""Algorithm 2 — Thermal-Aware Energy Optimization.

The port of ``repro.core.energy_opt``. Every (V_core, V_bram) pair runs at
the maximum frequency its thermal steady state allows; the pair minimizing
E = P_total x d_max is chosen (§III-C: at fixed voltage, max frequency is
energy-optimal). A thin wrapper over the shared Solver with the
``MinEnergy`` policy, which evaluates every pair in each fixed-point
iteration (``use_pruning`` is kept for API compatibility and ignored).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

from repro_torch.core import characterization as C
from repro_torch.core import thermal
from repro_torch.core.netlist import Netlist
from repro_torch.core.voltage_scaling import baseline_power
from repro_torch.policy import MinEnergy, cached_solver, fpga_substrate


@dataclass
class EnergyResult:
    v_core: float
    v_bram: float
    d_opt_ns: float  # chosen clock period
    d_worst_ns: float  # baseline clock period
    power_mw: float
    energy: float  # P x d  [mW ns]
    baseline_energy: float
    saving: float
    freq_ratio: float  # f_opt / f_base = d_worst / d_opt
    n_refined: int = 0
    n_pruned: int = 0
    wall_full_est_s: float = 0.0
    wall_s: float = 0.0


def _safe_div(num: float, den: float, default: float = 0.0) -> float:
    """Guard the degenerate-loop hazards (zero refined pairs / zero delay)."""
    return num / den if den else default


def run(netlist: Netlist, t_amb: float, act_in: float = 1.0,
        tc: thermal.ThermalConfig = thermal.ThermalConfig(),
        lib: Optional[C.DeviceLibrary] = None,
        use_pruning: bool = True,
        delta_t: float = 0.1, max_iters: int = 8,
        device=None) -> EnergyResult:
    t0 = time.time()
    sub = fpga_substrate(netlist, lib, tc, device)
    solver = cached_solver(sub, MinEnergy(), delta_t, max(int(max_iters), 1))
    sol = solver.solve({"t_amb": t_amb, "act": act_in})

    vc, vb = sub.decode(sol.idx)
    # legacy semantics: delay re-evaluated at the converged temperatures,
    # power from the last search (the refine loop's final iteration)
    d_opt = float(sol.d_final[0])
    power = float(sol.power[0])
    energy = power * d_opt

    d_worst = sub.d_worst
    base_p, _ = baseline_power(netlist, t_amb, act_in, tc, lib,
                               device=sub.device)
    base_e = base_p * d_worst
    wall = time.time() - t0

    return EnergyResult(
        v_core=float(vc[0]), v_bram=float(vb[0]),
        d_opt_ns=d_opt, d_worst_ns=d_worst, power_mw=power, energy=energy,
        baseline_energy=base_e,
        saving=1.0 - _safe_div(energy, base_e, default=1.0),
        freq_ratio=_safe_div(d_worst, d_opt),
        # the batched solver sweeps the whole grid each iteration: report
        # fixed-point iterations where the legacy flow reported pair counts
        n_refined=int(sol.n_iters), n_pruned=0,
        wall_full_est_s=wall, wall_s=wall,
    )
