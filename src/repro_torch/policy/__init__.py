"""repro_torch.policy — the Substrate/Policy/Solver stack of the port.

    from repro_torch import policy as pol

    sub = pol.fpga_substrate(netlist, tc=thermal.ThermalConfig(theta_ja=12.0))
    sol = pol.cached_solver(sub, pol.PowerSave()).solve(
        {"t_amb": 60.0, "act": 1.0})
    v_core, v_bram = sub.decode(sol.idx)

``fpga_substrate`` takes ``device=None`` (the CUDA card) or ``"cpu"``.
"""
from repro_torch.policy.policies import (ABFT_ESCAPE, SDC_RATE0, SDC_RATE_K,
                                         ErrorTolerant, MinEnergy, Overscale,
                                         Policy, PowerSave, escaped_sdc_rate,
                                         from_spec, overshoot_budget)
from repro_torch.policy.solver import Solution, Solver, cached_solver
from repro_torch.policy.substrate import (T_GUARD, V_BRAM_GRID, V_CORE_GRID,
                                          FpgaNetlistSubstrate, Substrate,
                                          fpga_substrate)

__all__ = [
    "Policy", "PowerSave", "MinEnergy", "Overscale", "ErrorTolerant",
    "from_spec", "escaped_sdc_rate", "overshoot_budget",
    "SDC_RATE0", "SDC_RATE_K", "ABFT_ESCAPE",
    "Solver", "Solution", "cached_solver",
    "Substrate", "FpgaNetlistSubstrate", "fpga_substrate",
    "T_GUARD", "V_CORE_GRID", "V_BRAM_GRID",
]
