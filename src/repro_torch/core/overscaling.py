"""Timing-speculative voltage over-scaling (§III-D) + error model.

The port of ``repro.core.overscaling``. For a violation budget gamma >= 1,
Algorithm 1's timing constraint is relaxed to ``delay <= gamma * d_worst``
while the clock stays at d_worst — the obtained voltages are optimal for
that allowed violation (the paper's flow). The search is the shared
:class:`repro_torch.policy.Solver` with the ``Overscale`` policy; gamma
rides in the solver environment, so :func:`sweep` evaluates a whole gamma
schedule as one batched solve (``Solver.solve_batch``), on the card unless
``device="cpu"``.

The post-P&R timing simulation is replaced by a functional error model:
gate-level simulation of an FPGA netlist becomes an error-injection profile
derived from the violating-path population:

- a path p with delay d_p(V, T) > d_worst produces an erroneous capture when
  it is exercised (prob = its toggle activity),
- the depth of violation determines which accumulator bits are wrong:
  small overshoots corrupt only the last-arriving (high-order / carry) bits.

``error_profile`` returns per-bit flip probabilities for a W-bit accumulator;
``kernels/overscale_matmul`` consumes it during app inference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import characterization as C
from repro_torch.core import netlist as NL
from repro_torch.core import thermal
from repro_torch.core.netlist import Netlist
from repro_torch.core.voltage_scaling import baseline_power
from repro_torch.policy import Overscale, Policy, cached_solver, fpga_substrate
from repro_torch.policy.substrate import T_GUARD

# carry-tail shape: a violation of depth x corrupts the top
# ceil(x / X_FULL * CARRY_BITS) accumulator bits
CARRY_BITS = 12
X_FULL = 0.40  # overshoot at which the whole carry tail is corrupt


@dataclass
class OverscaleResult:
    gamma: float
    v_core: float
    v_bram: float
    power_mw: float
    baseline_mw: float
    saving: float
    frac_violating: float  # activity-weighted fraction of paths over d_worst
    mean_overshoot: float  # mean (d_p/d_worst - 1)+ over violating paths
    bit_probs: np.ndarray  # (32,) per-bit flip probability per MAC
    t_junct: float = 0.0


def _result(sub, sol, netlist, gamma, act_in, base) -> OverscaleResult:
    vc, vb = sub.decode(sol.idx)
    vc, vb = float(vc[0]), float(vb[0])
    power = float(sol.power[0])
    T = torch.as_tensor(sol.T, device=sub.device)
    frac, overshoot, bit_probs = error_profile(
        sub.lib, sub.nlt, netlist, T, vc, vb, sub.d_worst, act_in)
    return OverscaleResult(
        gamma=float(gamma), v_core=vc, v_bram=vb, power_mw=power,
        baseline_mw=base, saving=1.0 - power / base,
        frac_violating=frac, mean_overshoot=overshoot, bit_probs=bit_probs,
        t_junct=float(np.mean(sol.T)))


def run(netlist: Netlist, gamma: float, t_amb: float = 40.0,
        act_in: float = 1.0,
        tc: thermal.ThermalConfig = thermal.ThermalConfig(theta_ja=12.0),
        lib: Optional[C.DeviceLibrary] = None,
        delta_t: float = 0.1, max_iters: int = 8,
        policy: Optional[Policy] = None, device=None) -> OverscaleResult:
    """Algorithm 1 with relaxed constraint gamma * d_worst.

    A custom constraint ``policy`` may be supplied; its gamma is superseded
    by the explicit ``gamma`` argument, which always rides in the solver
    environment.
    """
    sub = fpga_substrate(netlist, lib, tc, device)
    solver = cached_solver(sub, policy or Overscale(), delta_t,
                           max(int(max_iters), 1))
    sol = solver.solve({"t_amb": t_amb, "act": act_in, "gamma": gamma})
    base, _ = baseline_power(netlist, t_amb, act_in, tc, lib,
                             device=sub.device)
    return _result(sub, sol, netlist, gamma, act_in, base)


def sweep(netlist: Netlist, gammas, t_amb: float = 40.0, act_in: float = 1.0,
          tc: thermal.ThermalConfig = thermal.ThermalConfig(theta_ja=12.0),
          lib: Optional[C.DeviceLibrary] = None,
          delta_t: float = 0.1, max_iters: int = 8, device=None
          ) -> List[OverscaleResult]:
    """Gamma sweep as one batched fixed-point call (§III-D study)."""
    gammas = [float(x) for x in gammas]
    g = np.asarray(gammas, np.float32)
    sub = fpga_substrate(netlist, lib, tc, device)
    solver = cached_solver(sub, Overscale(), delta_t, max(int(max_iters), 1))
    sol = solver.solve_batch({
        "t_amb": np.full_like(g, t_amb),
        "act": np.full_like(g, act_in),
        "gamma": g,
    })
    base, _ = baseline_power(netlist, t_amb, act_in, tc, lib,
                             device=sub.device)
    # report the exact requested gammas, not their float32 round-trips
    return [_result(sub, type(sol)(*(x[i] for x in sol)), netlist,
                    gammas[i], act_in, base)
            for i in range(len(g))]


def error_profile(lib, nlt, netlist: Netlist, T_tiles, v_core, v_bram,
                  d_worst, act_in, word_bits: int = 32):
    """Violating-path population -> per-bit flip probabilities.

    Bits [word_bits-CARRY_BITS, word_bits) are the carry/MSB tail that the
    last-arriving signals feed; a violation of depth x (= d_p/d_worst - 1)
    corrupts the top ceil(x / X_FULL * CARRY_BITS) of them. The path delays
    run on T_tiles' device; the loop over the (256) violating paths runs on
    the host, as in the reference.
    """
    d = NL.path_delays(lib, nlt, T_tiles + T_GUARD, v_core,
                       v_bram).cpu().numpy()
    v = d / d_worst - 1.0
    viol = v > 0
    frac = float(viol.mean())
    overshoot = float(v[viol].mean()) if viol.any() else 0.0

    # per-path capture probability: exercised with internal activity
    act = float(C.internal_activity(act_in))
    bit_probs = np.zeros(word_bits)
    if viol.any():
        for x in v[viol]:
            depth = min(int(np.ceil(x / X_FULL * CARRY_BITS)), CARRY_BITS)
            lo = word_bits - depth
            bit_probs[lo:] += act / len(d)
    return frac, overshoot, np.clip(bit_probs, 0.0, 1.0)
