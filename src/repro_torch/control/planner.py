"""FleetPlanner — the Algorithm 1/2 planning core of the control plane.

The port of ``repro.control.planner``. The fixed points run through the
port's :class:`repro_torch.policy.Solver` on the substrate's device; what
comes back (rails, powers, the converged field) is numpy on the host, as
the reference returns it.

- :meth:`plan` — one full fixed point (rails -> thermal solve -> repeat),
  returning the legacy :class:`PlanOut` plus the converged temperature
  field for warm restarts.
- the **nominal-baseline cache**: the baseline solve (nominal rails at
  their own fixed point) is policy-independent per environment
  ``(t_amb, util)`` — gamma only enters feasibility, and the nominal-only
  substrate has a single candidate that the fallback re-selects either
  way — so it is solved once per environment and memoized
  (``baseline_solves`` counts actual solves).
- :meth:`lut` / :meth:`build_lut` — the §III-B dynamic scheme: replans for
  *many* ambient environments go through ONE ``solve_batch`` call.
- :meth:`rail_field` — the 2-axis per-chip fast path: ONE ``solve_batch``
  (early-freeze) call over the whole ``ambient x utilization`` knot grid,
  plus one batched nominal-only solve producing the per-chip baseline on
  the same grid (prefilled into the nominal-baseline cache, carried on the
  :class:`RailField` for interpolated readouts).
- :meth:`mitigate` — straggler rail-boost-or-rebalance as a pure decision
  (the controller turns it into an actuator command).
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch import policy as pol
from repro_torch.control.lut import DEFAULT_UTIL_KNOTS, DynamicLut, RailField
from repro_torch.core import tpu_fleet as TF


@dataclass
class PlanOut:
    """The fleet plan record (the reference's golden-pinned fields)."""
    v_core: np.ndarray  # (chips,)
    v_sram: np.ndarray
    f_rel: np.ndarray
    power_w: np.ndarray
    step_s: float
    pod_power_w: float
    baseline_power_w: float
    saving: float
    t_mean: float
    t_max: float


_BASELINE_CACHE_LIMIT = 64  # environments; ambient sweeps must not pin RAM


class FleetPlanner:
    """Planning + mitigation decisions over one ``TpuFleetSubstrate``."""

    def __init__(self, substrate: pol.TpuFleetSubstrate, policy: pol.Policy,
                 prof: TF.StepProfile, lib: TF.TpuLibrary,
                 delta_t: float = 0.5, max_iters: int = 6):
        self.substrate = substrate
        self.policy = policy
        self.prof = prof
        self.lib = lib
        self.delta_t = delta_t
        self.max_iters = max_iters
        self._baseline: "OrderedDict" = OrderedDict()
        self.baseline_solves = 0  # cache-miss counter
        self.T_last: Optional[np.ndarray] = None  # last converged field

    # ------------------------------------------------------------------
    def env(self, t_amb: float, util: Optional[np.ndarray] = None) -> Dict:
        chips = self.substrate.n_domains
        us = np.asarray(util if util is not None else np.ones(chips),
                        np.float32)
        e = {"t_amb": t_amb, "util": us, "gamma": self.policy.gamma}
        # budget-carrying policies (ErrorTolerant) ride their accuracy
        # budget in the env so budget sweeps batch like gamma sweeps do
        b = getattr(self.policy, "budget", None)
        if b is not None:
            e["budget"] = float(b)
        return e

    # ------------------------------------------------------------------
    def baseline_power(self, env: Dict, delta_t: Optional[float] = None,
                       max_iters: Optional[int] = None) -> np.ndarray:
        """Nominal rails at their own fixed point — cached per environment.

        Keyed on (t_amb, util): the nominal-only substrate has exactly one
        candidate and ``nominal_fallback`` re-selects it whether or not the
        gamma-relaxed contract holds, so gamma cannot change the result.
        """
        delta_t = self.delta_t if delta_t is None else delta_t
        max_iters = self.max_iters if max_iters is None else max_iters
        key = (float(env["t_amb"]),
               np.asarray(env["util"], np.float32).tobytes(),
               float(delta_t), int(max_iters))
        if key in self._baseline:
            self._baseline.move_to_end(key)
            return self._baseline[key]
        bsolver = pol.cached_solver(self.substrate.nominal_only(),
                               pol.PowerSave(), delta_t, max_iters)
        pb = np.asarray(bsolver.solve(env).power)  # last-search power
        self._baseline[key] = pb
        self.baseline_solves += 1
        if len(self._baseline) > _BASELINE_CACHE_LIMIT:
            self._baseline.popitem(last=False)
        return pb

    # ------------------------------------------------------------------
    def plan(self, env: Dict, T0, max_iters: Optional[int] = None,
             delta_t: Optional[float] = None) -> Tuple[PlanOut, np.ndarray]:
        """Fixed point: choose rails -> thermal solve -> repeat.

        Returns ``(PlanOut, T_converged)``; the caller owns the warm
        temperature estimate.
        """
        mi = self.max_iters if max_iters is None else max_iters
        dt = self.delta_t if delta_t is None else delta_t
        sol = pol.cached_solver(self.substrate, self.policy, dt, mi).solve(
            env, T0=T0)
        self.T_last = np.asarray(sol.T)

        pb = self.baseline_power(env, dt, mi)

        vc, vs = self.substrate.decode(sol.idx)
        f = np.asarray(sol.f)
        p = np.asarray(sol.power)
        f_pod = float(f.min())  # synchronous step: slowest chip rules
        step_s = float(TF.step_time(self.prof, f_pod))
        if self.policy.metric == "energy":
            # energy-per-step ratio (P x t), the paper's Algorithm-2 metric
            saving = 1.0 - (float(p.sum()) * step_s) / (
                float(pb.sum()) * self.prof.step_s)
        else:
            saving = 1.0 - float(p.sum()) / float(pb.sum())
        out = PlanOut(
            v_core=vc, v_sram=vs, f_rel=f, power_w=p, step_s=step_s,
            pod_power_w=float(p.sum()),
            baseline_power_w=float(pb.sum()),
            saving=saving,
            t_mean=float(np.mean(sol.T)), t_max=float(np.max(sol.T)),
        )
        return out, np.asarray(sol.T)

    def plan_at(self, t_amb: float, util: Optional[np.ndarray] = None,
                T0=None) -> Tuple[PlanOut, np.ndarray]:
        """Plan for a sensed environment; ``T0=None`` warm-starts from the
        last converged field (cold start only before any plan has run)."""
        env = self.env(t_amb, util)
        if T0 is None:
            T0 = (self.T_last if self.T_last is not None
                  else self.substrate.T0({"t_amb": t_amb}))
        return self.plan(env, T0)

    # ------------------------------------------------------------------
    def lut(self, t_ambs,
            util: Optional[np.ndarray] = None
            ) -> Dict[float, Tuple[float, float]]:
        """§III-B dynamic scheme: per-ambient (v_core, v_sram) medians, from
        ONE batched solve over the whole ambient sweep."""
        chips = self.substrate.n_domains
        t = np.asarray([float(x) for x in t_ambs], np.float32)
        B = len(t)
        us = np.asarray(util if util is not None else np.ones(chips),
                        np.float32)
        envs = {
            "t_amb": t,
            "util": np.broadcast_to(us, (B, chips)).copy(),
            "gamma": np.full((B,), self.policy.gamma, np.float32),
        }
        b = getattr(self.policy, "budget", None)
        if b is not None:
            envs["budget"] = np.full((B,), float(b), np.float32)
        sol = pol.cached_solver(self.substrate, self.policy, self.delta_t,
                           self.max_iters).solve_batch(envs)
        out = {}
        for i in range(B):
            vc, vs = self.substrate.decode(sol.idx[i])
            out[float(t[i])] = (float(np.median(vc)), float(np.median(vs)))
        return out

    def build_lut(self, t_ambs,
                  util: Optional[np.ndarray] = None) -> DynamicLut:
        """The interpolating scalar lookup (legacy pod-median fast path)."""
        return DynamicLut(self.lut(t_ambs, util))

    # ------------------------------------------------------------------
    def _grid_envs(self, t_ambs, u_levels) -> Dict:
        """The flattened ``K_t x K_u`` environment batch (row-major: the
        utilization axis varies fastest)."""
        chips = self.substrate.n_domains
        t = np.asarray([float(x) for x in t_ambs], np.float32)
        u = np.asarray([float(x) for x in u_levels], np.float32)
        B = t.size * u.size
        envs = {
            "t_amb": np.repeat(t, u.size),
            "util": np.tile(u, t.size)[:, None]
            * np.ones((1, chips), np.float32),
            "gamma": np.full((B,), self.policy.gamma, np.float32),
        }
        b = getattr(self.policy, "budget", None)
        if b is not None:
            envs["budget"] = np.full((B,), float(b), np.float32)
        return envs

    def rail_field(self, t_ambs, u_levels=DEFAULT_UTIL_KNOTS,
                   with_baseline: bool = True,
                   early_freeze: bool = True) -> RailField:
        """Solve the per-chip 2-axis rail table: ONE batched fixed point
        over the whole ``ambient x utilization`` grid (``early_freeze``
        compacts converged grid points out between segments, with the same
        decisions as the lockstep path). ``with_baseline`` adds one batched
        nominal-only solve over the same grid, prefilling the
        per-environment baseline cache and attaching the per-chip nominal
        power to the field."""
        t = [float(x) for x in t_ambs]
        u = [float(x) for x in u_levels]
        Kt, Ku = len(t), len(u)
        chips = self.substrate.n_domains
        envs = self._grid_envs(t, u)
        sol = pol.cached_solver(self.substrate, self.policy, self.delta_t,
                           self.max_iters).solve_batch(
                               envs, early_freeze=early_freeze)
        vc, vs = self.substrate.decode(sol.idx)  # (B, chips)
        p_nom = None
        if with_baseline:
            p_nom = self._baseline_grid(envs, (Kt, Ku, chips), early_freeze,
                                        t, u)
        return RailField(t, u, vc.reshape(Kt, Ku, chips),
                         vs.reshape(Kt, Ku, chips), p_nom=p_nom)

    def _baseline_grid(self, envs: Dict, shape, early_freeze: bool,
                       t_knots, u_levels) -> np.ndarray:
        """Per-chip nominal-baseline power over the sweep grid — one
        batched nominal-only solve, prefilled into the per-environment
        cache so a replan/readout AT a grid knot never re-solves it.

        Cache keys are built from the ORIGINAL python-float knots:
        ``baseline_power`` keys on the caller's float64 ambient. (The
        reference also runs one single-environment solve here to compile
        it ahead of the control loop; the port has nothing to compile.)"""
        bsolver = pol.cached_solver(self.substrate.nominal_only(),
                               pol.PowerSave(), self.delta_t, self.max_iters)
        bsol = bsolver.solve_batch(envs, early_freeze=early_freeze)
        pb = np.asarray(bsol.power)  # (B, chips); last-search power
        for i in range(pb.shape[0]):
            key = (float(t_knots[i // len(u_levels)]),
                   np.asarray(envs["util"][i], np.float32).tobytes(),
                   float(self.delta_t), int(self.max_iters))
            if key not in self._baseline:
                self._baseline[key] = pb[i]
                if len(self._baseline) > _BASELINE_CACHE_LIMIT:
                    self._baseline.popitem(last=False)
        return pb.reshape(shape)

    # ------------------------------------------------------------------
    def mitigate(self, plan: PlanOut, chip: int, T_chip: float) -> Dict:
        """Hot/slow chip: try boosting its rails back to nominal (perf-
        preserving, costs power); report if even that can't hold the clock.

        Pure decision (host scalars) — application is the actuator's job.
        """
        f_at_nom = float(TF.f_max_rel(self.lib, TF.V_CORE_NOM,
                                      TF.V_SRAM_NOM, T_chip + 2.0))
        if f_at_nom >= 1.0:
            return {"action": "boost_rail", "chip": chip,
                    "v_core": TF.V_CORE_NOM, "v_sram": TF.V_SRAM_NOM,
                    "extra_power_w": float(
                        TF.chip_power(self.lib, self.prof, TF.V_CORE_NOM,
                                      TF.V_SRAM_NOM, 1.0, T_chip)
                        - plan.power_w[chip])}
        return {"action": "rebalance", "chip": chip,
                "reason": f"T={T_chip:.1f}C cannot hold f_nom even at "
                          f"nominal rails (f_max={f_at_nom:.3f})"}
