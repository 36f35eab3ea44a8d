"""EnergyAwareRuntime — Algorithm 1/2 driving a (simulated) TPU pod.

The port of ``repro.core.runtime``: a thin composition over the control
plane's :class:`~repro_torch.control.planner.FleetPlanner`, which owns the
fixed point, the cached nominal baseline, the batched §III-B LUT build and
straggler mitigation decisions.

- ``power_save``  (Algorithm 1): per-chip (v_core, v_sram) minimizing pod
  power subject to the step-time contract (f stays nominal);
- ``min_energy``  (Algorithm 2): additionally scales frequency; minimizes
  energy per step (P x t_step);
- ``overscale:g`` (§III-D): relaxes the contract by g.

``plan()`` / ``dynamic_lut()`` / ``straggler_mitigation()`` keep the
reference's signatures and numbers (``tests/test_torch_control.py`` holds
them to the reference's). The fixed points run on ``device`` (``None`` is
the CUDA card; ``"cpu"`` when asked); the warm field ``T`` is kept on the
host, where the planner's results land.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch import policy as pol
from repro_torch.control.lut import DEFAULT_UTIL_KNOTS, DynamicLut
from repro_torch.control.planner import FleetPlanner, PlanOut  # noqa: F401
from repro_torch.core import tpu_fleet as TF

_SPEC_NAMES = {pol.Overscale: "overscale", pol.MinEnergy: "min_energy",
               pol.PowerSave: "power_save",
               pol.ErrorTolerant: "error_tolerant"}


class EnergyAwareRuntime:
    def __init__(self, profile: TF.StepProfile,
                 policy: Union[str, pol.Policy] = "power_save",
                 grid: Tuple[int, int] = (16, 16), t_amb: float = 25.0,
                 lib: Optional[TF.TpuLibrary] = None,
                 theta_chip: float = 0.20, device=None):
        self.lib = lib or TF.TpuLibrary()
        self.prof = profile
        self.policy_obj = pol.from_spec(policy)
        self.gamma = self.policy_obj.gamma
        # the spec string ("power_save" | "min_energy" | "overscale" | ...)
        self.policy = _SPEC_NAMES.get(type(self.policy_obj),
                                      type(self.policy_obj).__name__)
        self.m, self.n = grid
        self.t_amb = t_amb
        self.substrate = pol.tpu_substrate(profile, self.lib, grid,
                                           theta_chip, device=device)
        self.device = self.substrate.device
        self.tc = self.substrate.thermal_cfg
        self.planner = FleetPlanner(self.substrate, self.policy_obj,
                                    profile, self.lib)
        self.T = self.substrate.T0({"t_amb": t_amb}).cpu().numpy()
        self.history: List[Dict] = []

    # ------------------------------------------------------------------
    def plan(self, util_scale: Optional[np.ndarray] = None,
             max_iters: int = 6, delta_t: float = 0.5) -> PlanOut:
        """Fixed point: choose rails -> thermal solve -> repeat."""
        out, self.T = self.planner.plan(
            self.planner.env(self.t_amb, util_scale), T0=self.T,
            max_iters=max_iters, delta_t=delta_t)
        self.history.append({"saving": out.saving, "t_max": out.t_max,
                             "step_s": out.step_s})
        return out

    # ------------------------------------------------------------------
    def dynamic_lut(self, t_ambs) -> Dict[float, Tuple[float, float]]:
        """Paper §III-B dynamic scheme: per-ambient (v_core, v_sram) medians
        from one batched solve; runtime state is not touched."""
        return self.planner.lut(t_ambs)

    def build_lut(self, t_ambs) -> DynamicLut:
        """Interpolating (clamped) scalar lookup over an ambient sweep."""
        return self.planner.build_lut(t_ambs)

    def build_field(self, t_ambs, u_levels=None, **kw):
        """Per-chip 2-axis (ambient x utilization) RailField — ONE
        early-freeze ``solve_batch`` over the whole sweep grid."""
        return self.planner.rail_field(
            t_ambs, DEFAULT_UTIL_KNOTS if u_levels is None else u_levels,
            **kw)

    def controller(self, **kw):
        """A :class:`~repro_torch.control.controller.LutController` over
        this runtime's planner (the per-chip RailField fast path unless
        ``lut=`` selects the pod-median scalar one)."""
        from repro_torch.control.controller import LutController
        return LutController(self.planner, **kw)

    # ------------------------------------------------------------------
    def straggler_mitigation(self, plan: PlanOut, chip: int,
                             slow_factor: float):
        """Hot/slow chip: try boosting its rails back to nominal (perf-
        preserving, costs power); report if even that can't hold the clock."""
        return self.planner.mitigate(plan, chip, float(self.T[chip]))
